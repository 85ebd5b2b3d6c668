"""Encrypted SHA-256 on the card: the second kvsp-class workload.

Generates the one-block Bristol SHA-256 netlist (~114k gates over ~3,700
levels), schedules it with the native C++ core, and evaluates it with
runtime.run_schedule over a batch of encrypted padded message blocks,
verifying every digest against hashlib. Reports blocks/s, effective
bootstraps/s and the peak device memory. The counterpart of
benchmarks/sha256.py.

    python -m cufhe_tpu_torch.benchmarks.sha256   # SHA_BATCH=32, SHA_PARAMS

Prints one JSON line; needs a CUDA device.
"""
from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np


def run(ctx, sk, batch: int, seed: int = 12) -> dict:
    """SHA-256 of `batch` random messages of 0-55 bytes on ctx; every
    digest checked against hashlib."""
    from .. import decrypt_bits, encrypt_bits
    from ..runtime import netlists as NL
    from ..runtime.bristol import compile_bristol
    from .aes import run_circuit

    t0 = time.perf_counter()
    sched, _ = compile_bristol(NL.sha256_block_bristol())
    schedule_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    msgs = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 56, batch)]
    in_bits = np.array([NL.bits_of(NL.sha256_pad(m)) for m in msgs]).T
    cts = [encrypt_bits(b, sk, rng, device=ctx.device) for b in in_bits]
    outs, rec = run_circuit(ctx, sched, cts)
    out_bits = np.stack([decrypt_bits(o, sk) for o in outs])
    errors = sum(NL.bytes_of(out_bits[:, i]) != hashlib.sha256(m).digest()
                 for i, m in enumerate(msgs))
    return {"bench": "sha256", "params": ctx.params.name, "batch": batch,
            **rec, "blocks_per_sec": batch / rec["seconds"],
            "sec_per_block": rec["seconds"] / batch,
            "schedule_seconds": schedule_s, "digest_errors": int(errors)}


def main() -> int:
    from ._common import (device_record, load_or_make_bench_keys,
                          require_cuda)
    from .. import Context
    require_cuda()
    sk, ek = load_or_make_bench_keys(
        os.environ.get("SHA_PARAMS", "tfhepp_128bit"))
    rec = run(Context(ek), sk, int(os.environ.get("SHA_BATCH", "32")))
    rec["device"] = device_record()
    print(json.dumps(rec))
    return 1 if rec["digest_errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
