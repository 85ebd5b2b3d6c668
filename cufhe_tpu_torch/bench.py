"""Headline benchmark of the port: batched lvl0 NAND gate bootstraps per
second on one CUDA device, by default at tfhepp_128bit on the exact path.

Mirrors the JAX package's bench.py measurement: gates chain on their own
outputs, so ciphertexts stay on the device; each timed rep is a chain of
BENCH_ITERS gates ended by a synchronise; the result is the median over
BENCH_REPS reps, and the final output is decrypt-checked. BENCH_BACKEND
(default auto; pallas3 the reduced-precision path, ntt) and BENCH_PARAMS
(a preset name, default tfhepp_128bit) choose the Context, as the JAX
bench reads them; the record names both.

    python -m cufhe_tpu_torch.bench      # BENCH_BATCH, BENCH_ITERS, BENCH_REPS,
                                         # BENCH_BACKEND, BENCH_PARAMS

Prints one JSON line. Needs a CUDA device; there is no CPU mode (run()
takes device="cpu" for the tests).
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

from .models.api import Context, decrypt_bits, encrypt_bits

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
    def sync():
        if out.data.is_cuda:
            torch.cuda.synchronize()

    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = ctx.nand(out, b)
        sync()
        times.append((time.perf_counter() - t0) / iters)
    return out, times


def settings() -> dict:
    """run()'s arguments from the environment: BENCH_PARAMS (a preset
    name), BENCH_BACKEND, BENCH_BATCH, BENCH_ITERS, BENCH_REPS."""
    from .params import PRESETS
    pname = os.environ.get("BENCH_PARAMS", "") or "tfhepp_128bit"
    if pname not in PRESETS:
        raise ValueError(f"BENCH_PARAMS={pname!r}: not one of "
                         f"{sorted(PRESETS)}")
    return {"params": PRESETS[pname],
            "backend": os.environ.get("BENCH_BACKEND", "auto"),
            "batch": int(os.environ.get("BENCH_BATCH", "4096")),
            "iters": int(os.environ.get("BENCH_ITERS", "20")),
            "reps": int(os.environ.get("BENCH_REPS", "5"))}


def run(params, backend: str, batch: int, iters: int, reps: int,
        device="cuda") -> dict:
    """The measurement on `device`: keys from seeds 0 and 1, a warm-up
    gate, then `reps` chains of `iters` NANDs. Returns the record without
    the device's name."""
    from . import golden as G

    sk = G.keygen(params, seed=0)
    ek = G.make_eval_key(sk, seed=1)
    ctx = Context(ek, backend=backend, device=device)
    rng = np.random.default_rng(7)
    bits0 = rng.integers(0, 2, batch)
    bits1 = rng.integers(0, 2, batch)
    a = encrypt_bits(bits0, sk, rng, device=device)
    b = encrypt_bits(bits1, sk, rng, device=device)

    out = ctx.nand(a, b)                  # warm-up: builds the kernel
    out, times = time_nand_chain(ctx, out, b, iters, reps)
    dt = statistics.median(times)
    errors = int(np.sum(decrypt_bits(out, sk) != expected_nand_chain(
        bits0, bits1, 1 + iters * reps)))
    rate = batch / dt
    return {
        "metric": METRIC, "value": rate, "unit": "gates/s",
        "vs_baseline": rate / BASELINE, "batch": batch,
        "ms_per_batch": dt * 1e3, "iters": iters, "reps": reps,
        "rep_ms_per_batch": [t * 1e3 for t in times],
        "params": params.name, "backend": backend, "decrypt_errors": errors}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the bench measures the GPU only",
              file=sys.stderr)
        return 2
    rec = run(**settings())
    print(json.dumps({**rec, "device": {
        "name": torch.cuda.get_device_name(0),
        "power_limit": card()["power_limit"]}}))
    return 0 if rec["decrypt_errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
