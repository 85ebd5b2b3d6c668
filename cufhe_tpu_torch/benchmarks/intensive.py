"""Stress and async-correctness bench on real CUDA streams: the
reference's test_intensive (test_intensive.cc:21-54). Many logical
streams each run a chain of dependent gates (each consumes the previous
output), driven by a completion-polling scheduler that enqueues the next
gate the moment a lane is idle; then everything is decrypted and checked
against the plaintext recurrence. The counterpart of
benchmarks/intensive.py.

`--streams` is the batch (ciphertexts per gate call), split into `--lanes`
independent chains, each on its own runtime.Stream (a torch.cuda.Stream):
while lane 0's gate runs, lane 1's is already enqueued. `--fused` runs each
lane's whole chain as one Context.gate_chain call.

    python -m cufhe_tpu_torch.benchmarks.intensive [--streams 512]
        [--chain 20] [--lanes 1] [--fused] [--params tfhepp_128bit]

Prints one JSON line with the card's name and power limit; needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run(ctx, sk, streams: int, chain: int, lanes: int, fused: bool = False,
        seed: int = 3) -> dict:
    """`lanes` dependent nand/xor chains of depth `chain` over `streams`
    ciphertexts on ctx, one Stream per lane; timed on the host clock from
    the first enqueue to the last synchronise."""
    from .. import Ctxt, decrypt_bits, encrypt_bits
    from ..runtime import Stream, stream_query, synchronize
    from ..utils.spans import counts

    if streams % lanes:
        raise ValueError("--streams must divide by --lanes")
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, streams)
    other_bits = rng.integers(0, 2, streams)
    cts = encrypt_bits(bits, sk, rng, device=ctx.device)
    other = encrypt_bits(other_bits, sk, rng, device=ctx.device)
    lb = streams // lanes
    lane_out = [Ctxt(cts.data[i * lb:(i + 1) * lb], 0) for i in range(lanes)]
    lane_oth = [Ctxt(other.data[i * lb:(i + 1) * lb], 0)
                for i in range(lanes)]
    names = ["nand" if d % 2 == 0 else "xor" for d in range(chain)]

    ctx.nand(lane_out[0], lane_oth[0])        # warm-up: builds the kernel
    synchronize()
    sts = [Stream(ctx.device) for _ in range(lanes)]
    before = counts()["blind_rotate"]
    polls = 0
    t0 = time.perf_counter()
    if fused:
        for ln in range(lanes):
            lane_out[ln] = ctx.gate_chain(names, lane_out[ln], lane_oth[ln],
                                          stream=sts[ln])
    else:
        for nm in names:
            for ln in range(lanes):
                # the reference's scheduler: poll, then enqueue the lane's
                # next gate on its own stream
                while not stream_query(sts[ln]):
                    polls += 1
                lane_out[ln] = ctx.gate(nm, lane_out[ln], lane_oth[ln],
                                        stream=sts[ln])
    synchronize(*sts)
    dt = time.perf_counter() - t0
    launches = counts()["blind_rotate"] - before

    want = bits.copy()
    for nm in names:
        want = 1 - (want & other_bits) if nm == "nand" else want ^ other_bits
    got = np.concatenate([decrypt_bits(o, sk) for o in lane_out])
    return {"metric": "intensive_chained_gate_ops_per_sec",
            "value": streams * chain / dt, "streams": streams,
            "chain_depth": chain, "lanes": lanes, "fused": fused,
            "polls": polls, "seconds": dt,
            "ms_per_chain_step": dt / chain * 1e3,
            "rotation_launches": launches, "params": ctx.params.name,
            "errors": int(np.sum(got != want))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=512)
    ap.add_argument("--chain", type=int, default=20)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--fused", action="store_true",
                    help="each lane's chain as one Context.gate_chain call")
    ap.add_argument("--params", default="tfhepp_128bit")
    args = ap.parse_args()

    from ._common import (device_record, load_or_make_bench_keys,
                          require_cuda)
    from .. import Context
    require_cuda()
    sk, ek = load_or_make_bench_keys(args.params)
    rec = run(Context(ek), sk, args.streams, args.chain, args.lanes,
              args.fused)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["device"] = device_record()
    print(json.dumps(rec))
    return 1 if rec["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
