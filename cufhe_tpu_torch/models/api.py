"""Public host API: Context + typed ciphertext batches.

The counterpart of cufhe_tpu/models/api.py. Keys and ciphertexts live on
one explicit torch device; ciphertexts stay there between gates, and move
to the host only at decrypt. Every method runs eagerly: what the JAX
package compiles into one program (gate_chain's scan) is a Python loop of
the same ops here, bit-identical to the separate calls.

Streams (runtime.stream.Stream, the reference's cuFHE stream model): a
method given stream= runs on that stream's device and CUDA stream, with
the keys for that device. Every ciphertext made on a CUDA device carries a
ready event recorded after the work that made it, and every consumer (a
gate on any stream, decrypt_bits) waits for it first, so chaining across
streams needs no explicit synchronise. A Ctxt without an event is taken to
have been made on the caller's current stream.
"""
from __future__ import annotations

import contextlib
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
    #: recorded on the CUDA stream that made `data`, after that work
    ready: Optional[torch.cuda.Event] = None

    @property
    def batch(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class TrlweCtxt:
    """A batch of TRLWE ciphertexts [B, k+1, N] int32."""
    data: torch.Tensor


def encrypt_bits(bits: Sequence[int], sk: G.SecretKey,
                 rng: Optional[np.random.Generator] = None, level: int = 0,
                 *, device="cuda") -> Ctxt:
    """Encrypt bits into a ciphertext batch at `level` on `device` (client
    side, NumPy), by default the card, where Context keeps its keys. The
    positional order is the JAX package's (bits, sk, rng, level).
    rng=None draws from the OS CSPRNG; pass a seeded Generator only for
    reproducible tests."""
    data = from_u32(G.encrypt_bit_batch(bits, sk, rng, level=level), device)
    return Ctxt(data, level, _ready_event(data))


def decrypt_bits(ct: Ctxt, sk: G.SecretKey) -> np.ndarray:
    """Decrypt a ciphertext batch to a bit array (client side), after the
    work that made it."""
    if ct.ready is not None:
        torch.cuda.current_stream(ct.data.device).wait_event(ct.ready)
    return G.decrypt_bit_batch(to_u32(ct.data), sk, level=ct.level)


def _ready_event(t: torch.Tensor) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream of t's device, or None on
    the CPU."""
    if t.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


#: the JAX package's backend names whose results are exact and equal to
#: each other ("auto" picks one of them there); the port runs every one as
#: its one exact path (the blind rotation of ops/blind_rotate.py)
EXACT_BACKENDS = ("auto", "pallas", "conv", "toeplitz")


def resolve_backend(backend: str) -> str:
    """The port's path for a JAX backend name: "pallas" for every exact
    backend; the ntt parity path and the reduced-precision "pallas3" are
    not ported, and any other name is refused."""
    if backend in EXACT_BACKENDS:
        return "pallas"
    if backend == "ntt":
        raise NotImplementedError("the ntt backend is not ported yet "
                                  "(ROADMAP queue 1 item 4)")
    if backend == "pallas3":
        raise NotImplementedError("backend 'pallas3' (reduced precision) is "
                                  "left out of the port; use an exact "
                                  f"backend, one of {EXACT_BACKENDS}")
    raise ValueError(f"unknown backend {backend!r}; the port's exact "
                     f"backends are {EXACT_BACKENDS}")


class Context:
    """Server-side evaluation context on one device.

    Converts the evaluation key to limb form once and keeps it on `device`.
    Every blind rotation on CUDA tensors runs through the CUDA kernel, on
    CPU tensors through its plain PyTorch version. `backend` takes the JAX
    package's names (resolve_backend) and is kept as given in
    self.backend.
    """

    #: DeviceKeys fields of each key form, the unit of release_keys and
    #: prepare_backend: "pallas" is the blind rotation's key (the port's one
    #: form of it, which every exact backend name selects), "ksk" every key
    #: switch's
    _BACKEND_KEY_FIELDS = {"pallas": ("bk_ext",),
                           "ksk": ("ksk_limbs_sei", "sei_perm")}

    def __init__(self, ek: G.EvalKey, backend: str = "auto", mesh=None, *,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError("multi-device meshes are not ported "
                                      "yet (ROADMAP queue 1 item 3)")
        resolve_backend(backend)
        self.backend = backend
        self.params: GateParams = ek.params
        self.keys = K.prepare_keys(ek, torch.device(device))
        self.device = self.keys.device      # "cuda" resolved to "cuda:0"
        self._dev_keys = {}

    # -- key lifecycle ------------------------------------------------------
    @staticmethod
    def _key_form(backend: str) -> str:
        return "ksk" if backend == "ksk" else resolve_backend(backend)

    def release_keys(self, backends: Optional[Sequence[str]] = None) -> None:
        """Free device key material now (the DeleteBootstrappingKeyNTT /
        DeleteKeySwitchingKey analogue, bootstrap_gpu.cuh:50-165,
        keyswitch_gpu.cuh:190-196): a long-lived server swapping presets
        must not hold two key sets.

        backends=None frees every key; an exact backend name such as
        ("pallas",) frees the blind rotation's key, ("ksk",) the key
        switch's. Work already enqueued is waited for first, and the
        caching allocator hands the memory back to the device. Gates raise
        ValueError until prepare_backend restores the keys."""
        names = (self._BACKEND_KEY_FIELDS if backends is None
                 else [self._key_form(b) for b in backends])
        fields = {f for b in names for f in self._BACKEND_KEY_FIELDS[b]}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._dev_keys = {}
        self.keys = dataclasses.replace(self.keys, **{
            f: getattr(self.keys, f).new_empty((0,)) for f in fields})
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def prepare_backend(self, ek: G.EvalKey, backend: str = "auto") -> None:
        """(Re-)build one key form from the host EvalKey on the context's
        device (an exact backend name: the blind rotation's key; "ksk": the
        key switch's), and the key switch's too if a release dropped it:
        the inverse of release_keys."""
        if ek.params != self.params:
            raise ValueError(f"eval key is for {ek.params.name}, the context "
                             f"for {self.params.name}; use reinitialize")
        form = self._key_form(backend)
        fields = set(self._BACKEND_KEY_FIELDS[form])
        if not self.keys.ksk_limbs_sei.numel():
            fields |= set(self._BACKEND_KEY_FIELDS["ksk"])
        self.keys = dataclasses.replace(
            self.keys, **K.prepare_fields(ek, fields, self.device))
        self._dev_keys = {}
        if form != "ksk":
            self.backend = backend

    def reinitialize(self, ek: G.EvalKey, backend: str = "auto") -> None:
        """Preset swap for a long-lived server: free every device key of
        the current parameter set, then prepare the keys of a new EvalKey
        (its parameters may differ) on the same device. Ciphertexts of the
        old set are invalid."""
        resolve_backend(backend)
        self.release_keys()
        self.params = ek.params
        self.backend = backend
        self.keys = K.prepare_keys(ek, self.device)

    def _check_keys(self) -> None:
        for f in dataclasses.fields(self.keys):
            if not getattr(self.keys, f.name).numel():
                raise ValueError(f"evaluation key {f.name} was released "
                                 f"(Context.release_keys); restore it with "
                                 f"Context.prepare_backend(ek)")

    # -- where work runs -----------------------------------------------------
    def _keys_on(self, dev: torch.device) -> K.DeviceKeys:
        """The keys on `dev`: the context's own set when the devices match
        (compared as tensor devices), else a copy made once."""
        self._check_keys()
        if dev == self.device:
            return self.keys
        if dev not in self._dev_keys:
            self._dev_keys[dev] = K.DeviceKeys(**{
                f.name: getattr(self.keys, f.name).to(dev)
                for f in dataclasses.fields(self.keys)})
        return self._dev_keys[dev]

    @staticmethod
    def _lane(stream):
        """The body runs on the stream's CUDA stream, or without a stream
        (or on a CPU lane) on the caller's current stream."""
        if stream is not None and stream.cuda_stream is not None:
            return torch.cuda.stream(stream.cuda_stream)
        return contextlib.nullcontext()

    def _take(self, ct: Ctxt, dev: torch.device, caller) -> torch.Tensor:
        """ct's data on `dev`, ordered after the work that made it on the
        stream that runs the body (called inside _lane)."""
        x = ct.data
        if ct.ready is not None:
            torch.cuda.current_stream(x.device).wait_event(ct.ready)
        if x.device != dev:
            x = x.to(dev)
        elif dev.type == "cuda":
            cur = torch.cuda.current_stream(dev)
            if ct.ready is None and caller is not None and cur != caller:
                cur.wait_stream(caller)
            # the allocator must not reuse x's memory before this stream
            # has read it
            x.record_stream(cur)
        return x

    def _run(self, stream, level: int, fn, *cts: Ctxt,
             keys: bool = True) -> Ctxt:
        """fn(keys, *data) on stream's lane (or the context's device) with
        every input waited for; the result, with its ready event."""
        if stream is None:
            dev = self.device
            self._on_device(*cts)
        else:
            dev = stream.device
        k = self._keys_on(dev) if keys else None
        caller = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)
        with self._lane(stream):
            out = fn(k, *(self._take(ct, dev, caller) for ct in cts))
            res = Ctxt(out, level, _ready_event(out))
        if stream is not None:
            stream.record(res)
        return res

    def _inputs(self, *cts: Ctxt) -> list:
        """The inputs' data on the context's device, ordered after their
        producers on the current stream (the executor's entry)."""
        self._on_device(*cts)
        return [self._take(ct, self.device, None) for ct in cts]

    def _outputs(self, datas: Sequence[torch.Tensor], level: int) -> list:
        """Ctxts of tensors made on the current stream, sharing one ready
        event."""
        ev = _ready_event(datas[0]) if datas else None
        return [Ctxt(d, level, ev) for d in datas]

    def _on_device(self, *cts: Ctxt) -> None:
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
        return B.gate_lvl0 if in0.level == 0 else B.gate_lvl1

    def _mu(self, level: int) -> int:
        return self.params.lvl0.mu if level == 0 else self.params.lvl1.mu

    # -- two-input gates --------------------------------------------------
    def gate(self, name: str, in0: Ctxt, in1: Ctxt, stream=None) -> Ctxt:
        """Evaluate one of the ten bootstrapped two-input gates on a batch
        at either level."""
        if name not in GATE_CONSTANTS:
            raise ValueError(f"unknown gate {name!r}; "
                             f"choose from {sorted(GATE_CONSTANTS)}")
        fn = self._two_input(in0, in1)
        c = GATE_CONSTANTS[name]
        return self._run(stream, in0.level,
                         lambda k, x, y: fn(c, x, y, k, self.params),
                         in0, in1)

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
        return self._run(None, in0.level,
                         lambda k, x, y: fn(c3, x, y, k, self.params),
                         in0, in1)

    def gate_chain(self, name, in0: Ctxt, in1: Ctxt,
                   depth: Optional[int] = None, stream=None) -> Ctxt:
        """Dependent gate chain: out = gate(out, in1), one step per gate.
        `name` is one gate name (applied `depth` times) or a sequence of
        names, one per step. A loop of the same gate calls, so
        bit-identical to them; the outputs stay on the device."""
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

        def chain(k, out, y):
            for nm in names:
                out = fn(GATE_CONSTANTS[nm], out, y, k, self.params)
            return out
        return self._run(stream, in0.level, chain, in0, in1)

    def mux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, negate: bool = False,
            stream=None) -> Ctxt:
        """Mux(inc ? in1 : in0), or its negation: two blind rotations."""
        if not (inc.level == in1.level == in0.level):
            raise ValueError("mux inputs must share a level")
        if not (inc.data.shape == in1.data.shape == in0.data.shape):
            raise ValueError("mux input batches differ")
        fn = B.mux_lvl0 if inc.level == 0 else B.mux_lvl1
        return self._run(stream, inc.level,
                         lambda k, c, x1, x0: fn(c, x1, x0, k, self.params,
                                                 negate=negate),
                         inc, in1, in0)

    def nmux(self, inc: Ctxt, in1: Ctxt, in0: Ctxt, stream=None) -> Ctxt:
        return self.mux(inc, in1, in0, negate=True, stream=stream)

    # -- linear gates -------------------------------------------------------
    def not_(self, ct: Ctxt, stream=None) -> Ctxt:
        return self._run(stream, ct.level, lambda _, x: B.not_gate(x), ct,
                         keys=False)

    def copy(self, ct: Ctxt, stream=None) -> Ctxt:
        return self._run(stream, ct.level, lambda _, x: B.copy_gate(x), ct,
                         keys=False)

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
        return TrlweCtxt(B.refresh(tr.data, self._keys_on(self.device),
                                   self.params))

    def bootstrap_tlwe2trlwe(self, ct: Ctxt,
                             mu: Optional[int] = None) -> TrlweCtxt:
        mu = self.params.lvl1.mu if mu is None else mu
        return TrlweCtxt(self._run(None, ct.level, lambda k, x:
                                   B.bootstrap_tlwe2trlwe(x, mu, k,
                                                          self.params),
                                   ct).data)

    def pbs_tlwe2trlwe(self, ct: Ctxt, tv) -> TrlweCtxt:
        """Programmable bootstrap, TLWE -> TRLWE: blind-rotate a custom test
        polynomial tv ([N] or [B, N], uint32 array or int32 tensor) by the
        input phase."""
        t = self._tensor(tv)
        return TrlweCtxt(self._run(None, ct.level, lambda k, x:
                                   B.pbs_tlwe2trlwe(x, t, k, self.params),
                                   ct).data)

    def programmable_bootstrap(self, ct: Ctxt, tv) -> Ctxt:
        """Custom-test-vector blind rotation, extraction, key switch to
        lvl0: the output encrypts tv[w] (negacyclically -tv[w - N]) where w
        is the mod-switched phase window of the input."""
        t = self._tensor(tv)
        return self._run(None, 0, lambda k, x: B.programmable_bootstrap(
            x, t, k, self.params), ct)

    def sample_extract_and_keyswitch(self, tr: TrlweCtxt) -> Ctxt:
        out = B.sei_and_ks(tr.data, self._keys_on(self.device), self.params)
        return Ctxt(out, 0, _ready_event(out))

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
