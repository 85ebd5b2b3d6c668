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

Meshes (parallel.mesh.DataMesh, the reference's SetGPUNum): a context built
with mesh= keeps its keys on every device of the mesh and its ciphertexts
on the mesh's first device; every batched method cuts its batch into one
row block per shard, runs each block on its device and joins the results
there (parallel.mesh.data_parallel). Streams and a mesh exclude each
other, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from .. import golden as G
from ..ops import bootstrap as B
from ..ops import keys as K
from ..ops.bootstrap import resolve_backend
from ..parallel import mesh as M
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


def _warn_pallas3() -> None:
    """The JAX package's warning on every pallas3 Context (its
    models/api.py:78-87), word for word."""
    warnings.warn(
        "backend='pallas3' is an EXPERIMENTAL reduced-precision "
        "mode (~2.6 sigma worst-gate margin, per-gate failure "
        "rates ~1e-3 for XOR-class gates on bootstrapped inputs); "
        "prefer the default exact backend", stacklevel=3)


class Context:
    """Server-side evaluation context on one device, or on a mesh.

    Converts the evaluation key once to the form its path reads and keeps
    it on `device` (with a mesh: on every mesh device, the context living
    on the first). `backend` takes the JAX package's names
    (ops.bootstrap.resolve_backend) and is kept as given in self.backend:
    every exact name runs the blind rotation of ops/blind_rotate.py (the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors),
    "pallas3" the same rotation with a three-limb key (reduced precision:
    it warns, as the JAX package does), "ntt" the RAINTT-prime path of
    ops/ntt.py on the same device.
    """

    #: DeviceKeys fields of each key form, the unit of release_keys and
    #: prepare_backend (ops.keys.KEY_FORMS): "pallas" is the exact blind
    #: rotation's key, "pallas3" its three-limb form, "ntt" the ntt path's,
    #: "ksk" every key switch's
    _BACKEND_KEY_FIELDS = K.KEY_FORMS

    def __init__(self, ek: G.EvalKey, backend: str = "auto", mesh=None, *,
                 device="cuda"):
        if backend == "pallas3":
            _warn_pallas3()
        self._path = resolve_backend(backend)
        self.backend = backend
        self.params: GateParams = ek.params
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.keys = K.prepare_keys(ek, torch.device(device), (self._path,))
        self.device = self.keys.device      # "cuda" resolved to "cuda:0"
        self._dev_keys = {}
        self._replicate()

    # -- key lifecycle ------------------------------------------------------
    @staticmethod
    def _key_form(backend: str) -> str:
        return "ksk" if backend == "ksk" else resolve_backend(backend)

    def _replicate(self) -> None:
        """The keys on every device of the mesh (ops on the context's own
        device use its own set)."""
        if self.mesh is not None:
            self._dev_keys = {d: k for d, k in
                              M.replicate(self.keys, self.mesh).items()
                              if d != self.device}

    def release_keys(self, backends: Optional[Sequence[str]] = None) -> None:
        """Free device key material now (the DeleteBootstrappingKeyNTT /
        DeleteKeySwitchingKey analogue, bootstrap_gpu.cuh:50-165,
        keyswitch_gpu.cuh:190-196): a long-lived server swapping presets
        must not hold two key sets.

        backends=None frees every key; an exact backend name such as
        ("pallas",), or ("pallas3",), frees the blind rotation's key,
        ("ntt",) the ntt path's, ("ksk",) the key switch's. The copies on
        stream and mesh devices are always dropped. Work already enqueued
        is waited for first, and the caching allocator hands the memory
        back to the device. Gates raise ValueError until prepare_backend
        restores the keys."""
        names = (self._BACKEND_KEY_FIELDS if backends is None
                 else [self._key_form(b) for b in backends])
        fields = {f for b in names for f in self._BACKEND_KEY_FIELDS[b]}
        for dev in {self.device, *self._dev_keys}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._dev_keys = {}
        self.keys = dataclasses.replace(self.keys, **{
            f: getattr(self.keys, f).new_empty((0,)) for f in fields})
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def prepare_backend(self, ek: G.EvalKey, backend: str = "auto") -> None:
        """(Re-)build one key form from the host EvalKey on the context's
        device (an exact backend name: the blind rotation's key; "pallas3":
        that key at three limbs, in its place; "ntt": the ntt path's;
        "ksk": the key switch's), and the key switch's too if a
        release dropped it, and copy the keys to the mesh's devices again:
        the inverse of release_keys. A backend name also switches the
        context's path to it."""
        if ek.params != self.params:
            raise ValueError(f"eval key is for {ek.params.name}, the context "
                             f"for {self.params.name}; use reinitialize")
        form = self._key_form(backend)
        if form == "pallas3":
            _warn_pallas3()
        forms = {form}
        if not self.keys.ksk_tiles.numel():
            forms.add("ksk")
        self.keys = dataclasses.replace(
            self.keys, **K.prepare_fields(ek, forms, self.device))
        self._dev_keys = {}
        self._replicate()
        if form != "ksk":
            self.backend = backend
            self._path = form

    def reinitialize(self, ek: G.EvalKey, backend: str = "auto") -> None:
        """Preset swap for a long-lived server: free every device key of
        the current parameter set, then prepare the keys of a new EvalKey
        (its parameters may differ) on the same device, or mesh. Ciphertexts
        of the old set are invalid."""
        path = resolve_backend(backend)
        if path == "pallas3":
            _warn_pallas3()
        self.release_keys()
        self.params = ek.params
        self.backend, self._path = backend, path
        self.keys = K.prepare_keys(ek, self.device, (path,))
        self._replicate()

    def _check_keys(self) -> None:
        """Raise if a key the context's path reads was released: its
        rotation's form and the key switch's (the other forms are never
        built for it)."""
        for f in (*self._BACKEND_KEY_FIELDS[self._path],
                  *self._BACKEND_KEY_FIELDS["ksk"]):
            if not getattr(self.keys, f).numel():
                raise ValueError(f"evaluation key {f} was released "
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
            self._dev_keys[dev] = M.to_device(self.keys, dev)
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

    def _map(self, fn, batch: Sequence[torch.Tensor], shared=(),
             out_dim: int = 0, dev: Optional[torch.device] = None,
             keys: bool = True):
        """fn(keys, *batch, *shared) on `dev` (by default the context's
        device) with that device's keys; under a mesh, on every shard
        (parallel.mesh.data_parallel): the batch tensors' rows split across
        the mesh, `shared` copied to each shard's device, the outputs
        joined along out_dim on the context's device. The one way every
        batched method, IntContext and the executor reach the keys and the
        mesh. keys=False (cmux) passes None for the keys and checks none."""
        key_of = self._keys_on if keys else (lambda d: None)
        if self.mesh is None:
            return fn(key_of(dev or self.device), *batch, *shared)
        keys = M.Replicated({d: key_of(d) for d in self.mesh.devices})
        return M.data_parallel(fn, self.mesh, range(1, 1 + len(batch)),
                               out_dim)(keys, *batch, *shared)

    def _run(self, stream, level: int, fn, *cts: Ctxt, rows=(), shared=(),
             keys: bool = True) -> Ctxt:
        """fn(keys, *data, *rows, *shared) on stream's lane (or the
        context's device, or its mesh) with every input waited for; the
        result, with its ready event. `rows` are per-row operands on the
        context's device that travel with the ciphertext rows under a mesh,
        `shared` operands every shard reads whole. keys=False (the linear
        gates) reads no key and runs unsharded."""
        if stream is None:
            dev = self.device
            self._on_device(*cts)
        elif self.mesh is not None:
            raise ValueError("stream dispatch and mesh sharding are mutually "
                             "exclusive on one Context")
        else:
            dev = stream.device
        caller = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)
        with self._lane(stream):
            data = [self._take(ct, dev, caller) for ct in cts]
            if keys:
                out = self._map(fn, [*data, *rows], shared, dev=dev)
            else:
                out = fn(None, *data)
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
                         lambda k, x, y: fn(c, x, y, k, self.params,
                                            self._path), in0, in1)

    def gate_rows(self, c3_rows, in0: Ctxt, in1: Ctxt) -> Ctxt:
        """A mix of two-input gates in one batch: row i of c3_rows ([G, 3]
        from ops.bootstrap.encode_gate_consts_rows, an int32 tensor or a
        uint32 array) holds gate i's constants. G divides the batch B and
        the rows are tiled gate-major: ciphertext row r takes constant row
        r // (B // G). Under a mesh the tiled constants are cut with the
        ciphertext rows."""
        fn = self._two_input(in0, in1)
        c3 = self._tensor(c3_rows)
        Bsz = in0.batch
        if c3.dim() != 2 or c3.shape[1] != 3 or c3.shape[0] == 0 \
                or Bsz % c3.shape[0]:
            raise ValueError(f"gate rows must be [G, 3] with G dividing the "
                             f"batch {Bsz}, got {tuple(c3.shape)}")
        c3 = c3.repeat_interleave(Bsz // c3.shape[0], dim=0)
        return self._run(None, in0.level,
                         lambda k, x, y, c: fn(c, x, y, k, self.params,
                                               self._path),
                         in0, in1, rows=(c3,))

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
                out = fn(GATE_CONSTANTS[nm], out, y, k, self.params,
                         self._path)
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
                                                 negate, self._path),
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
        """c0 + TRGSW (external product) (c1 - c0), batched: the one exact
        product on every backend (as the JAX package's `ntt` cmux runs its
        exact Toeplitz product). Reads no evaluation key."""
        return TrlweCtxt(self._map(
            lambda _, x1, x0, tg: B.cmux(tg, x1, x0, self.params),
            [c1.data, c0.data], shared=(trgsw_dev,), keys=False))

    def refresh(self, tr: TrlweCtxt) -> TrlweCtxt:
        return TrlweCtxt(self._map(
            lambda k, x: B.refresh(x, k, self.params, self._path), [tr.data]))

    def bootstrap_tlwe2trlwe(self, ct: Ctxt,
                             mu: Optional[int] = None) -> TrlweCtxt:
        mu = self.params.lvl1.mu if mu is None else mu
        return TrlweCtxt(self._run(None, ct.level, lambda k, x:
                                   B.bootstrap_tlwe2trlwe(x, mu, k,
                                                          self.params,
                                                          self._path),
                                   ct).data)

    def _tv(self, tv) -> dict:
        """A test vector as _run's operand: [N] read whole by every shard,
        [B, N] cut with the ciphertext rows."""
        t = self._tensor(tv)
        return {"rows": (t,)} if t.dim() == 2 else {"shared": (t,)}

    def pbs_tlwe2trlwe(self, ct: Ctxt, tv) -> TrlweCtxt:
        """Programmable bootstrap, TLWE -> TRLWE: blind-rotate a custom test
        polynomial tv ([N] or [B, N], uint32 array or int32 tensor) by the
        input phase."""
        return TrlweCtxt(self._run(None, ct.level, lambda k, x, t:
                                   B.pbs_tlwe2trlwe(x, t, k, self.params,
                                                    self._path),
                                   ct, **self._tv(tv)).data)

    def programmable_bootstrap(self, ct: Ctxt, tv) -> Ctxt:
        """Custom-test-vector blind rotation, extraction, key switch to
        lvl0: the output encrypts tv[w] (negacyclically -tv[w - N]) where w
        is the mod-switched phase window of the input."""
        return self._run(None, 0, lambda k, x, t: B.programmable_bootstrap(
            x, t, k, self.params, self._path), ct, **self._tv(tv))

    def sample_extract_and_keyswitch(self, tr: TrlweCtxt) -> Ctxt:
        out = self._map(lambda k, x: B.sei_and_ks(x, k, self.params),
                        [tr.data])
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
