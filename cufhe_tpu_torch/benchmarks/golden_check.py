"""On-card uint32-exact golden check: the hardware bit-exactness proof, the
counterpart of benchmarks/golden_check.py.

The CPU tests prove the arithmetic through the plain PyTorch versions; what
they cannot exercise is the CUDA kernel itself. This runs a few samples of
three two-input gates and the mux at the full parameter set on the card and
diffs the output ciphertexts uint32 for uint32 against the port's NumPy
oracle (golden.gate_lvl0 and golden.mux_lvl0).

    python -m cufhe_tpu_torch.benchmarks.golden_check
        # GOLDEN_PARAMS (tfhepp_128bit), GOLDEN_BACKEND (auto),
        # GOLDEN_SAMPLES (8)

Prints one JSON line with the card's name and power limit and appends it
to the results file; exit 1 on any mismatched word, 2 without a CUDA
device. The NumPy gates take seconds each at the 128-bit sets, so main()
computes them in worker processes while the card runs.
"""
from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import Future, ProcessPoolExecutor

import numpy as np

from .. import golden as G
from ..models.api import Ctxt
from ..torus import from_u32, to_u32

#: the two-input gates golden_diff checks by default (the JAX check's)
GATES = ("nand", "xor", "andny")

#: the eval key of a worker process (pool_init)
_EK = None


def pool_init(ek) -> None:
    """Initializer of a golden worker process: keeps the eval key."""
    global _EK
    _EK = ek


def golden_pool(ek, workers: int) -> ProcessPoolExecutor:
    """A pool of spawned worker processes for golden_diff's oracle calls."""
    return ProcessPoolExecutor(
        workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=pool_init, initargs=(ek,))


def _gate_job(name, x, y, ek=None):
    return G.gate_lvl0(name, x, y, _EK if ek is None else ek)


def _mux_job(c, x, y, ek=None):
    return G.mux_lvl0(c, x, y, _EK if ek is None else ek)


def golden_diff(ctx, sk, ek, rng, nb: int = 8, gates=GATES,
                check_mux: bool = True, pool=None):
    """uint32 mismatch count between the context's gates (and mux) and the
    golden model on nb fresh samples each. Returns (mismatched_words,
    total_words). With a pool made by golden_pool (or initialised with
    pool_init), the oracle runs there while the context computes."""
    bits = [rng.integers(0, 2, nb) for _ in range(3)]
    ga, gb, gc = ([G.encrypt_bit(int(v), sk, rng) for v in bs]
                  for bs in bits)
    a, b, c = (Ctxt(from_u32(np.stack(cts), ctx.device), 0)
               for cts in (ga, gb, gc))

    def oracle(fn, *args):
        return fn(*args, ek=ek) if pool is None else pool.submit(fn, *args)

    jobs = [(name, [oracle(_gate_job, name, ga[i], gb[i])
                    for i in range(nb)]) for name in gates]
    if check_mux:
        jobs.append(("mux", [oracle(_mux_job, gc[i], ga[i], gb[i])
                             for i in range(nb)]))
    mism = total = 0
    for name, rows in jobs:
        out = ctx.mux(c, a, b) if name == "mux" else ctx.gate(name, a, b)
        dev = to_u32(out.data)
        want = np.stack([r.result() if isinstance(r, Future) else r
                         for r in rows]).astype(np.uint32)
        mism += int(np.sum(dev != want))
        total += want.size
    return mism, total


def main() -> int:
    from .. import Context
    from ._common import (append_result, device_record,
                          load_or_make_bench_keys, require_cuda)
    require_cuda()
    pname = os.environ.get("GOLDEN_PARAMS", "tfhepp_128bit")
    backend = os.environ.get("GOLDEN_BACKEND", "auto")
    nb = int(os.environ.get("GOLDEN_SAMPLES", "8"))
    sk, ek = load_or_make_bench_keys(pname)
    ctx = Context(ek, backend=backend)
    rng = np.random.default_rng(23)
    with golden_pool(ek, os.cpu_count() or 1) as pool:
        mism, total = golden_diff(ctx, sk, ek, rng, nb=nb, pool=pool)
    rec = {"bench": "golden_onchip", "params": pname, "backend": backend,
           "samples": nb, "mismatched_words": mism, "total_words": total,
           "device": device_record()}
    print(json.dumps(rec))
    append_result(rec)
    return 1 if mism else 0


if __name__ == "__main__":
    raise SystemExit(main())
