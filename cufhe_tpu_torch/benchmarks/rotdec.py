"""The blind rotation's rotate-and-decompose kernel (rotdec_kernel in
csrc/blind_rotate.cu) alone on the card: its time a launch beside the
least time the card could take, which is set by bytes (acc read once, dec
written once, at the H100's device-memory rate).

    python -m cufhe_tpu_torch.benchmarks.rotdec [--params tfhepp_128bit]
        [--batch 4096,1] [--launches 25]

Each launch is timed between two CUDA events with the queue held full
(utils.timing.time_fn with a sleep kernel ahead of the launches, so no
host time falls inside a pair), the median over --launches: "warm"
launches follow each other on the same inputs, "cold" ones follow a write
of 128 MB that evicts the 50 MB L2. Each case is first held against
its plain version bit for bit (rotdec_ref, as leaf operands at the set's
Karatsuba depth). Prints one JSON line per case with the card's
name and power limit; exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.limbs import decomp_digit_limb_plan
from ._common import HBM_BYTES_PER_S

#: bytes written between cold launches: more than the 50 MB L2
FLUSH_BYTES = 128 << 20
#: cycles of the sleep kernel that holds the queue while launches enqueue
SLEEP_CYCLES = 200_000_000


def rotdec_bytes(params, rows: int) -> int:
    """Bytes one launch must move at `rows` accumulators: acc [rows, k+1,
    N] int32 and abar_i [rows] int32 read once, dec written once: [rows,
    I, N] int8 at Karatsuba depth 0, the leaf operands [rows, 3^d, I,
    N >> d] at the set's depth d (ops.blind_rotate.kar_depth)."""
    from ..ops.blind_rotate import kar_depth
    lp = params.lvl1
    kp1 = lp.k + 1
    I = kp1 * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    d = kar_depth(params)
    return rows * kp1 * lp.n * 4 + rows * 4 + rows * 3 ** d * I * (lp.n >> d)


def random_inputs(params, rows: int, seed: int, device):
    """Random acc [rows, k+1, N] and abar_i [rows] in [0, 2N), whose first
    rows take the wrap and sign cases 0, N-1, N and 2N-1."""
    from ..torus import from_u32
    lp = params.lvl1
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << 32, (rows, lp.k + 1, lp.n), dtype=np.uint64)
    abar = rng.integers(0, 2 * lp.n, rows)
    edges = [0, lp.n - 1, lp.n, 2 * lp.n - 1]
    abar[:min(rows, 4)] = edges[:min(rows, 4)]
    return (from_u32(acc.astype(np.uint32), device),
            from_u32(abar.astype(np.uint32), device))


def measure(params, rows: int, launches: int, seed: int = 5):
    """One case: bit-exact against its plain version, then warm and cold
    medians."""
    from ..ops import blind_rotate as BR
    from ..utils.timing import time_fn
    acc, abar = random_inputs(params, rows, seed, "cuda")
    want = BR.leaf_operands(BR.rotdec_ref(acc, abar, params),
                            BR.kar_depth(params))
    if not torch.equal(BR.rotdec_cuda(acc, abar, params), want):
        raise AssertionError(f"rotdec kernel differs from rotdec_ref at "
                             f"{params.name}, {rows} rows")
    nbytes = rotdec_bytes(params, rows)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"params": params.name, "rows": rows, "launches": launches,
           "bytes": nbytes, "bound_ms": bound_ms}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for name, between in (("warm", None), ("cold", flush.zero_)):
        ms = time_fn(BR.rotdec_cuda, acc, abar, params, iters=launches,
                     between=between, sleep_cycles=SLEEP_CYCLES) * 1e3
        rec[f"{name}_ms"] = ms
        rec[f"{name}_gb_s"] = nbytes / ms / 1e6
        rec[f"{name}_share_of_bound"] = bound_ms / ms
    return rec


def main() -> int:
    from ..params import PRESETS
    from ._common import device_record, require_cuda
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--batch", default="4096,1")
    ap.add_argument("--launches", type=int, default=25)
    args = ap.parse_args()
    params = PRESETS[args.params]
    dev = device_record()
    for rows in (int(b) for b in args.batch.split(",")):
        rec = measure(params, rows, args.launches)
        print(json.dumps({**rec, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
