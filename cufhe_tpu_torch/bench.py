"""Headline benchmark of the port: batched lvl0 NAND gate bootstraps per
second on one CUDA device at tfhepp_128bit.

Mirrors the JAX package's bench.py measurement: gates chain on their own
outputs, so ciphertexts stay on the device; each timed rep is a chain of
BENCH_ITERS gates ended by a synchronise; the result is the median over
BENCH_REPS reps, and the final output is decrypt-checked.

    python -m cufhe_tpu_torch.bench      # BENCH_BATCH, BENCH_ITERS, BENCH_REPS

Prints one JSON line. Needs a CUDA device; there is no CPU mode.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

METRIC = "nand_gate_bootstraps_per_sec_per_chip"
BASELINE = 8300.0  # derived A100 batched gates/s of the reference (BASELINE.md)


def card() -> dict:
    """Name and power limit of CUDA device 0, as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in line.split(",", 1))
    return {"name": name, "power_limit": limit, "nvidia_smi": line}


def expected_nand_chain(bits0: np.ndarray, bits1: np.ndarray,
                        n_gates: int) -> np.ndarray:
    want = np.asarray(bits0)
    for _ in range(n_gates):
        want = 1 - (want & bits1)
    return want


def time_nand_chain(ctx, out, b, iters: int, reps: int):
    """Run `reps` chains of `iters` NANDs (out = nand(out, b)), each timed
    on the host clock up to a synchronise. Returns (out, seconds per gate
    of each rep)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = ctx.nand(out, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / iters)
    return out, times


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the bench measures the GPU only",
              file=sys.stderr)
        return 2
    from . import TFHEPP_128, Context, decrypt_bits, encrypt_bits
    from . import golden as G

    batch = int(os.environ.get("BENCH_BATCH", "4096"))
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    params = TFHEPP_128

    sk = G.keygen(params, seed=0)
    ek = G.make_eval_key(sk, seed=1)
    ctx = Context(ek, device="cuda")
    rng = np.random.default_rng(7)
    bits0 = rng.integers(0, 2, batch)
    bits1 = rng.integers(0, 2, batch)
    a = encrypt_bits(bits0, sk, rng, device="cuda")
    b = encrypt_bits(bits1, sk, rng, device="cuda")

    out = ctx.nand(a, b)                  # warm-up: builds the kernel
    torch.cuda.synchronize()
    out, times = time_nand_chain(ctx, out, b, iters, reps)
    dt = statistics.median(times)
    errors = int(np.sum(decrypt_bits(out, sk) != expected_nand_chain(
        bits0, bits1, 1 + iters * reps)))
    rate = batch / dt
    print(json.dumps({
        "metric": METRIC, "value": rate, "unit": "gates/s",
        "vs_baseline": rate / BASELINE, "batch": batch,
        "ms_per_batch": dt * 1e3, "iters": iters, "reps": reps,
        "rep_ms_per_batch": [t * 1e3 for t in times],
        "params": params.name, "decrypt_errors": errors,
        "device": {"name": torch.cuda.get_device_name(0),
                   "power_limit": card()["power_limit"]}}))
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
