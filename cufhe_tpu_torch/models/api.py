"""Public host API: Context + typed ciphertext batches.

The counterpart of cufhe_tpu/models/api.py. Keys and ciphertexts live on
one explicit torch device; ciphertexts stay there between gates, and move
to the host only at decrypt. Every method runs eagerly: what the JAX
package compiles into one program (gate_chain's scan) is a Python loop of
the same ops here, bit-identical to the separate calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import golden as G
from ..ops import bootstrap as B
from ..ops import keys as K
from ..params import GateParams
from ..torus import from_u32, to_u32
from .gates import GATE_CONSTANTS


@dataclasses.dataclass
class Ctxt:
    """A batch of TLWE ciphertexts at one level."""
    data: torch.Tensor  # [B, dim+1] int32 (uint32 bits)
    level: int          # 0 (lvl0) or 1 (lvl1 domain)

    @property
    def batch(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class TrlweCtxt:
    """A batch of TRLWE ciphertexts [B, k+1, N] int32."""
    data: torch.Tensor


def encrypt_bits(bits: Sequence[int], sk: G.SecretKey,
                 rng: Optional[np.random.Generator] = None,
                 device="cuda", level: int = 0) -> Ctxt:
    """Encrypt bits into a ciphertext batch at `level` on `device` (client
    side, NumPy), by default the card, where Context keeps its keys.
    rng=None draws from the OS CSPRNG; pass a seeded Generator only for
    reproducible tests."""
    return Ctxt(from_u32(G.encrypt_bit_batch(bits, sk, rng, level=level),
                         device), level)


def decrypt_bits(ct: Ctxt, sk: G.SecretKey) -> np.ndarray:
    """Decrypt a ciphertext batch to a bit array (client side)."""
    return G.decrypt_bit_batch(to_u32(ct.data), sk, level=ct.level)


def _no_stream(stream) -> None:
    if stream is not None:
        raise NotImplementedError("streams are not ported yet "
                                  "(ROADMAP queue 1 item 10)")


class Context:
    """Server-side evaluation context on one device.

    Converts the evaluation key to limb form once and keeps it on `device`.
    Every blind rotation on CUDA tensors runs through the CUDA kernel, on
    CPU tensors through its plain PyTorch version.
    """

    def __init__(self, ek: G.EvalKey, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet (ROADMAP queue 1 item 14)")
        self.params: GateParams = ek.params
        self.keys = K.prepare_keys(ek, torch.device(device))
        self.device = self.keys.device      # "cuda" resolved to "cuda:0"

    def _on_device(self, *cts) -> None:
        for ct in cts:
            if ct.data.device != self.device:
                raise ValueError(f"ciphertext on {ct.data.device}, context "
                                 f"on {self.device}")

    def _tensor(self, x) -> torch.Tensor:
        """A uint32 NumPy array or an int32 tensor, as int32 on the
        context's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32)
        return from_u32(np.asarray(x, dtype=np.uint32), self.device)

    def _two_input(self, in0: Ctxt, in1: Ctxt):
        if in0.level != in1.level:
            raise ValueError("gate inputs must share a level")
        if in0.data.shape != in1.data.shape:
            raise ValueError(f"gate input batches differ: "
                             f"{tuple(in0.data.shape)} vs "
                             f"{tuple(in1.data.shape)}")
        self._on_device(in0, in1)
        return B.gate_lvl0 if in0.level == 0 else B.gate_lvl1

    def _mu(self, level: int) -> int:
        return self.params.lvl0.mu if level == 0 else self.params.lvl1.mu

    # -- two-input gates --------------------------------------------------
    def gate(self, name: str, in0: Ctxt, in1: Ctxt, stream=None) -> Ctxt:
        """Evaluate one of the ten bootstrapped two-input gates on a batch
        at either level."""
        _no_stream(stream)
        if name not in GATE_CONSTANTS:
            raise ValueError(f"unknown gate {name!r}; "
                             f"choose from {sorted(GATE_CONSTANTS)}")
        fn = self._two_input(in0, in1)
        return Ctxt(fn(GATE_CONSTANTS[name], in0.data, in1.data, self.keys,
                       self.params), in0.level)

    def gate_rows(self, c3_rows, in0: Ctxt, in1: Ctxt) -> Ctxt:
        """A mix of two-input gates in one batch: row i of c3_rows ([G, 3]
        from ops.bootstrap.encode_gate_consts_rows, an int32 tensor or a
        uint32 array) holds gate i's constants. G divides the batch B and
        the rows are tiled gate-major: ciphertext row r takes constant row
        r // (B // G)."""
        fn = self._two_input(in0, in1)
        c3 = self._tensor(c3_rows)
        Bsz = in0.batch
        if c3.dim() != 2 or c3.shape[1] != 3 or c3.shape[0] == 0 \
                or Bsz % c3.shape[0]:
            raise ValueError(f"gate rows must be [G, 3] with G dividing the "
                             f"batch {Bsz}, got {tuple(c3.shape)}")
        c3 = c3.repeat_interleave(Bsz // c3.shape[0], dim=0)
        return Ctxt(fn(c3, in0.data, in1.data, self.keys, self.params),
                    in0.level)

    def gate_chain(self, name, in0: Ctxt, in1: Ctxt,
                   depth: Optional[int] = None, stream=None) -> Ctxt:
        """Dependent gate chain: out = gate(out, in1), one step per gate.
        `name` is one gate name (applied `depth` times) or a sequence of
        names, one per step. A loop of the same gate calls, so
        bit-identical to them; the outputs stay on the device."""
        _no_stream(stream)
        if isinstance(name, str):
            if depth is None:
                raise ValueError("depth is required with a single gate name")
            names = [name] * depth
        else:
            names = list(name)
            if depth is not None and depth != len(names):
                raise ValueError("depth disagrees with the gate-name "
                                 "sequence")
        if not names:
            raise ValueError("chain needs at least one gate")
        for nm in names:
            if nm not in GATE_CONSTANTS:
                raise ValueError(f"unknown gate {nm!r}")
        fn = self._two_input(in0, in1)
        out = in0.data
        for nm in names:
            out = fn(GATE_CONSTANTS[nm], out, in1.data, self.keys,
                     self.params)
        return Ctxt(out, in0.level)

    def mux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, negate: bool = False,
            stream=None) -> Ctxt:
        """Mux(inc ? in1 : in0), or its negation: two blind rotations."""
        _no_stream(stream)
        if not (inc.level == in1.level == in0.level):
            raise ValueError("mux inputs must share a level")
        if not (inc.data.shape == in1.data.shape == in0.data.shape):
            raise ValueError("mux input batches differ")
        self._on_device(inc, in1, in0)
        fn = B.mux_lvl0 if inc.level == 0 else B.mux_lvl1
        return Ctxt(fn(inc.data, in1.data, in0.data, self.keys, self.params,
                       negate=negate), inc.level)

    def nmux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, stream=None) -> Ctxt:
        return self.mux(inc, in1, in0, negate=True, stream=stream)

    # -- linear gates -------------------------------------------------------
    def not_(self, ct: Ctxt, stream=None) -> Ctxt:
        _no_stream(stream)
        return Ctxt(B.not_gate(ct.data), ct.level)

    def copy(self, ct: Ctxt, stream=None) -> Ctxt:
        _no_stream(stream)
        return Ctxt(B.copy_gate(ct.data), ct.level)

    # -- TRLWE / TRGSW path ---------------------------------------------
    def prepare_trgsw(self, trgsw: np.ndarray) -> torch.Tensor:
        """Limb form of one user TRGSW [(k+1)l, k+1, N] uint32 on the
        context's device, for cmux."""
        return K.prepare_trgsw(trgsw, self.params, self.device)

    def cmux(self, trgsw_dev: torch.Tensor, c1: TrlweCtxt,
             c0: TrlweCtxt) -> TrlweCtxt:
        """c0 + TRGSW (external product) (c1 - c0), batched."""
        return TrlweCtxt(B.cmux(trgsw_dev, c1.data, c0.data, self.params))

    def refresh(self, tr: TrlweCtxt) -> TrlweCtxt:
        return TrlweCtxt(B.refresh(tr.data, self.keys, self.params))

    def bootstrap_tlwe2trlwe(self, ct: Ctxt,
                             mu: Optional[int] = None) -> TrlweCtxt:
        mu = self.params.lvl1.mu if mu is None else mu
        return TrlweCtxt(B.bootstrap_tlwe2trlwe(ct.data, mu, self.keys,
                                                self.params))

    def pbs_tlwe2trlwe(self, ct: Ctxt, tv) -> TrlweCtxt:
        """Programmable bootstrap, TLWE -> TRLWE: blind-rotate a custom test
        polynomial tv ([N] or [B, N], uint32 array or int32 tensor) by the
        input phase."""
        return TrlweCtxt(B.pbs_tlwe2trlwe(ct.data, self._tensor(tv),
                                          self.keys, self.params))

    def programmable_bootstrap(self, ct: Ctxt, tv) -> Ctxt:
        """Custom-test-vector blind rotation, extraction, key switch to
        lvl0: the output encrypts tv[w] (negacyclically -tv[w - N]) where w
        is the mod-switched phase window of the input."""
        return Ctxt(B.programmable_bootstrap(ct.data, self._tensor(tv),
                                             self.keys, self.params), 0)

    def sample_extract_and_keyswitch(self, tr: TrlweCtxt) -> Ctxt:
        return Ctxt(B.sei_and_ks(tr.data, self.keys, self.params), 0)

    # -- named gate shorthands (the reference's public gate list) ---------
    def nand(self, a, b, stream=None): return self.gate("nand", a, b, stream=stream)
    def nor(self, a, b, stream=None): return self.gate("nor", a, b, stream=stream)
    def xnor(self, a, b, stream=None): return self.gate("xnor", a, b, stream=stream)
    def and_(self, a, b, stream=None): return self.gate("and", a, b, stream=stream)
    def or_(self, a, b, stream=None): return self.gate("or", a, b, stream=stream)
    def xor(self, a, b, stream=None): return self.gate("xor", a, b, stream=stream)
    def and_ny(self, a, b, stream=None): return self.gate("andny", a, b, stream=stream)
    def and_yn(self, a, b, stream=None): return self.gate("andyn", a, b, stream=stream)
    def or_ny(self, a, b, stream=None): return self.gate("orny", a, b, stream=stream)
    def or_yn(self, a, b, stream=None): return self.gate("oryn", a, b, stream=stream)
