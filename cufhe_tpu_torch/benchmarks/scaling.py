"""Data-parallel scaling harness: the counterpart of benchmarks/scaling.py
(the reference's test_gate_gpu_multi.cc analogue).

1. CPU mesh sweep: a NAND batch on a mesh of 1, 2, 4 and 8 CPU shards is
   bit-identical to the unsharded context, and the sharded gate calls no
   torch.distributed function (every public one is patched to raise while
   it runs). This is the mechanism: shards are independent, so scaling
   across cards is bounded by feeding them, not by communication.
2. On the card: the tfhepp_128bit NAND at batch 4096 on the plain context,
   on a one-device mesh (data_mesh()) and on two shards of the one card
   (data_mesh(["cuda:0", "cuda:0"])), timed in turns (plain, mesh-1,
   mesh-2, mesh-2, mesh-1, plain, ...), each a chain of gates on its own
   outputs ended by a synchronise. The meshes' gates/s as a share of the
   plain context's is the mesh layer's own cost; scaling across cards
   needs a machine with more than one.

    python -m cufhe_tpu_torch.benchmarks.scaling [--cpu-only]

Prints one JSON line per measurement (part 2's with the card's name and
power limit) and writes no file. Part 2 needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

#: part 1: the CPU meshes' shard counts and their batch
SHARDS, CPU_BATCH = (1, 2, 4, 8), 16
#: part 2: the main path's batch; gates a timed chain; turns of each context
BATCH, ITERS, ROUNDS = 4096, 4, 2


def _no_collectives():
    """A context that makes every public torch.distributed function raise
    while it is open."""
    import contextlib
    import unittest.mock as mock

    stack = contextlib.ExitStack()
    for name in dir(torch.distributed):
        if name.startswith("_") or not name[0].islower():
            continue
        if callable(getattr(torch.distributed, name)):
            def refuse(*args, _name=name, **kwargs):
                raise AssertionError(f"torch.distributed.{_name} called")
            stack.enter_context(mock.patch.object(torch.distributed, name,
                                                  refuse))
    return stack


def cpu_mesh_sweep() -> dict:
    """Sharded == unsharded NAND at PALLAS_TINY on CPU meshes."""
    from .. import PALLAS_TINY, Context, encrypt_bits
    from .. import golden as G
    from ..parallel import data_mesh
    sk = G.keygen(PALLAS_TINY, seed=21)
    ek = G.make_eval_key(sk, seed=22)
    rng = np.random.default_rng(23)
    a, b = (encrypt_bits(rng.integers(0, 2, CPU_BATCH), sk, rng, device="cpu")
            for _ in range(2))
    ref = Context(ek, device="cpu").nand(a, b).data
    rows = []
    for n in SHARDS:
        ctx = Context(ek, mesh=data_mesh(["cpu"] * n))
        with _no_collectives():
            got = ctx.nand(a, b).data
        rows.append({"shards": n, "bit_exact": bool(torch.equal(got, ref)),
                     "collectives": 0})
    return {"bench": "scaling", "metric": "cpu_mesh_sweep", "rows": rows,
            "pass": all(r["bit_exact"] for r in rows)}


def card_sharding_overhead() -> dict:
    """Gates/s of the tfhepp_128bit NAND at batch BATCH on the plain
    context, a one-device mesh and two shards of one card, timed in turns
    within this call."""
    from .. import Context, decrypt_bits, encrypt_bits
    from ..bench import expected_nand_chain
    from ..parallel import data_mesh
    from ..utils.spans import counts
    from ._common import device_record, load_or_make_bench_keys

    sk, ek = load_or_make_bench_keys("tfhepp_128bit")
    params = ek.params
    ctxs = {"plain": Context(ek), "mesh_1": Context(ek, mesh=data_mesh()),
            "mesh_2": Context(ek, mesh=data_mesh(["cuda:0", "cuda:0"]))}
    rng = np.random.default_rng(7)
    bits0, bits1 = rng.integers(0, 2, BATCH), rng.integers(0, 2, BATCH)
    a = encrypt_bits(bits0, sk, rng)
    b = encrypt_bits(bits1, sk, rng)
    outs = {name: ctx.nand(a, b) for name, ctx in ctxs.items()}  # warm-up
    times = {name: [] for name in ctxs}
    launches = {}
    order = list(ctxs) + list(ctxs)[::-1]
    for _ in range(ROUNDS):
        for name in order:
            torch.cuda.synchronize()
            before = counts()["blind_rotate"]
            t0 = time.perf_counter()
            for _ in range(ITERS):
                outs[name] = ctxs[name].nand(outs[name], b)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / ITERS)
            launches[name] = (counts()["blind_rotate"] - before) / ITERS
    # the warm-up gate, then ITERS per appearance in `order`
    want = expected_nand_chain(bits0, bits1, 1 + 2 * ITERS * ROUNDS)
    rate = {n: BATCH / statistics.median(t) for n, t in times.items()}
    return {
        "bench": "scaling", "metric": "card_sharding_overhead",
        "params": params.name, "batch": BATCH, "iters": ITERS,
        "gates_per_sec": rate,
        "rep_ms_per_batch": {n: [x * 1e3 for x in t]
                             for n, t in times.items()},
        "share_of_plain": {n: rate[n] / rate["plain"] for n in rate},
        "launches_per_gate": launches,
        "bit_exact": all(torch.equal(o.data, outs["plain"].data)
                         for o in outs.values()),
        "decrypt_errors": {n: int(np.sum(decrypt_bits(o, sk) != want))
                           for n, o in outs.items()},
        "cards": torch.cuda.device_count(),
        "device": device_record(),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-only", action="store_true")
    args = ap.parse_args()
    sweep = cpu_mesh_sweep()
    print(json.dumps(sweep), flush=True)
    ok = sweep["pass"]
    if not args.cpu_only:
        from ._common import require_cuda
        require_cuda()
        rec = card_sharding_overhead()
        print(json.dumps(rec), flush=True)
        ok = ok and rec["bit_exact"] and not any(
            rec["decrypt_errors"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
