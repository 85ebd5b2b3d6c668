"""Encrypted AES-128 on the card: the kvsp-class workload end to end.

Generates the Bristol AES-128 netlist (46,704 gates raw; the scheduler's
NOT/COPY absorption leaves 45,760 bootstrapped gates over 257 levels),
schedules it with the native C++ core, and evaluates it with
runtime.run_schedule over a batch of encrypted blocks, verifying every
output block against the plaintext aes128_encrypt_block. Reports blocks/s,
effective bootstraps/s and the peak device memory. The counterpart of
benchmarks/aes.py.

    python -m cufhe_tpu_torch.benchmarks.aes    # AES_BATCH=64, AES_PARAMS

Prints one JSON line; needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch


def bootstrapped(sched) -> int:
    """Bootstrapped gates of a schedule (not/copy are free; a mux counts
    once, as the JAX bench counts it)."""
    return sum(len(q) for lvl in sched.levels for op, q in lvl
               if op not in ("not", "copy"))


def run_circuit(ctx, sched, cts) -> dict:
    """run_schedule timed on the host clock to a synchronise, with the
    blind-rotation launches it made against the plan and the peak device
    memory. Returns the outputs and the numbers."""
    from ..runtime.executor import (plan_rotations, precompile_schedule,
                                    run_schedule, schedule_steps)
    from ..utils.spans import counts
    batch = cts[0].batch
    shapes = precompile_schedule(ctx, sched, batch)
    plans = schedule_steps(ctx, sched, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()["blind_rotate"]
    t0 = time.perf_counter()
    outs = run_schedule(ctx, sched, cts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    boots = bootstrapped(sched) * batch
    return outs, {
        "gates": sched.num_gates, "levels": sched.num_levels,
        "steps": sum(len(p) for p in plans), "step_shapes": shapes,
        "planned_rotations": plan_rotations(plans),
        "rotation_launches": counts()["blind_rotate"] - before,
        "seconds": dt, "bootstraps": boots,
        "bootstraps_per_sec": boots / dt,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def run(ctx, sk, batch: int, seed: int = 11) -> dict:
    """AES-128 over `batch` random (plaintext, key) pairs on ctx; every
    block checked against aes128_encrypt_block."""
    from .. import decrypt_bits, encrypt_bits
    from ..runtime import netlists as NL
    from ..runtime.bristol import compile_bristol

    t0 = time.perf_counter()
    sched, _ = compile_bristol(NL.aes128_bristol())
    schedule_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    pts = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
           for _ in range(batch)]
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(batch)]
    in_bits = np.array([NL.bits_of(p) + NL.bits_of(k)
                        for p, k in zip(pts, keys)]).T
    cts = [encrypt_bits(b, sk, rng, device=ctx.device) for b in in_bits]
    outs, rec = run_circuit(ctx, sched, cts)
    out_bits = np.stack([decrypt_bits(o, sk) for o in outs])
    errors = sum(NL.bytes_of(out_bits[:, i]) != NL.aes128_encrypt_block(p, k)
                 for i, (p, k) in enumerate(zip(pts, keys)))
    return {"bench": "aes128", "params": ctx.params.name, "batch": batch,
            **rec, "blocks_per_sec": batch / rec["seconds"],
            "sec_per_block": rec["seconds"] / batch,
            "schedule_seconds": schedule_s, "block_errors": int(errors)}


def main() -> int:
    from ._common import (device_record, load_or_make_bench_keys,
                          require_cuda)
    from .. import Context
    require_cuda()
    sk, ek = load_or_make_bench_keys(
        os.environ.get("AES_PARAMS", "tfhepp_128bit"))
    rec = run(Context(ek), sk, int(os.environ.get("AES_BATCH", "64")))
    rec["device"] = device_record()
    print(json.dumps(rec))
    return 1 if rec["block_errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
