"""Public host API for the lvl0 gate path: Context + typed ciphertext batches.

The counterpart of the main-path part of cufhe_tpu/models/api.py. Keys and
ciphertexts live on one explicit torch device; ciphertexts stay there
between gates, and move to the host only at decrypt.
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


def encrypt_bits(bits: Sequence[int], sk: G.SecretKey,
                 rng: Optional[np.random.Generator] = None,
                 device="cpu") -> Ctxt:
    """Encrypt bits into a lvl0 ciphertext batch on `device` (client side,
    NumPy). rng=None draws from the OS CSPRNG; pass a seeded Generator only
    for reproducible tests."""
    return Ctxt(from_u32(G.encrypt_bit_batch(bits, sk, rng), device), 0)


def decrypt_bits(ct: Ctxt, sk: G.SecretKey) -> np.ndarray:
    """Decrypt a ciphertext batch to a bit array (client side)."""
    return G.decrypt_bit_batch(to_u32(ct.data), sk, level=ct.level)


class Context:
    """Server-side evaluation context on one device.

    Converts the evaluation key to limb form once and keeps it on `device`.
    Gates on CUDA tensors run the blind rotation through the CUDA kernel,
    gates on CPU tensors through its plain PyTorch version.
    """

    def __init__(self, ek: G.EvalKey, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet (ROADMAP queue 1 item 14)")
        self.params: GateParams = ek.params
        self.keys = K.prepare_keys(ek, torch.device(device))
        self.device = self.keys.device      # "cuda" resolved to "cuda:0"

    def gate(self, name: str, in0: Ctxt, in1: Ctxt, stream=None) -> Ctxt:
        """Evaluate one of the ten bootstrapped two-input gates on a batch."""
        if stream is not None:
            raise NotImplementedError("streams are not ported yet "
                                      "(ROADMAP queue 1 item 10)")
        if name not in GATE_CONSTANTS:
            raise ValueError(f"unknown gate {name!r}; "
                             f"choose from {sorted(GATE_CONSTANTS)}")
        if in0.level != in1.level:
            raise ValueError("gate inputs must share a level")
        if in0.data.shape != in1.data.shape:
            raise ValueError(f"gate input batches differ: "
                             f"{tuple(in0.data.shape)} vs "
                             f"{tuple(in1.data.shape)}")
        for ct in (in0, in1):
            if ct.data.device != self.device:
                raise ValueError(f"ciphertext on {ct.data.device}, context "
                                 f"on {self.device}")
        if in0.level != 0:
            raise NotImplementedError("lvl1 gates are not ported yet "
                                      "(ROADMAP queue 1 item 7)")
        out = B.gate_lvl0(GATE_CONSTANTS[name], in0.data, in1.data,
                          self.keys, self.params)
        return Ctxt(out, 0)

    def gate_rows(self, c3_rows, in0: Ctxt, in1: Ctxt) -> Ctxt:
        raise NotImplementedError("gate_rows is not ported yet "
                                  "(ROADMAP queue 1 item 7)")

    def gate_chain(self, name, in0: Ctxt, in1: Ctxt,
                   depth: Optional[int] = None, stream=None) -> Ctxt:
        raise NotImplementedError("gate_chain is not ported yet "
                                  "(ROADMAP queue 1 item 7)")

    def mux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, negate: bool = False,
            stream=None) -> Ctxt:
        raise NotImplementedError("mux is not ported yet "
                                  "(ROADMAP queue 1 item 7)")

    def nmux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, stream=None) -> Ctxt:
        return self.mux(inc, in1, in0, negate=True, stream=stream)

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
