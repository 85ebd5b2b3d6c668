"""The key switch kernel (keyswitch_kernel in csrc/keyswitch.cu) alone on
the card, at the row counts the main path gives it: its time a launch
beside the least time the card could take (the KSK's and the rows' bytes
at the H100's device-memory rate, or its int8 operations at the
tensor-core rate, whichever is larger) and beside its plain version
(key_switch_ref, torch ops on the card).

    python -m cufhe_tpu_torch.benchmarks.keyswitch
        [--params tfhepp_128bit,concrete] [--rows 48,160,480,4096]
        [--launches 25]

Each launch is timed between two CUDA events with the queue held full
(utils.timing.time_fn with a sleep kernel ahead of the launches): "warm"
launches follow each other on the same inputs, "cold" ones follow a write
of 128 MB that evicts the 50 MB L2, as a key switch finds the KSK after a
blind rotation has streamed its key. Each case is first held against the
plain version bit for bit. The KSK is random: the arithmetic needs no real
key. Prints one JSON line per case with the card's name and power limit;
exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ._common import HBM_BYTES_PER_S, INT8_OPS_PER_S

#: bytes written between cold launches: more than the 50 MB L2
FLUSH_BYTES = 128 << 20
#: cycles of the sleep kernel that holds the queue while launches enqueue
SLEEP_CYCLES = 200_000_000
#: launches of the plain version (each a few ms)
YARDSTICK_LAUNCHES = 5


def ks_work(params, rows: int) -> tuple:
    """(int8 operations, bytes) one key switch of `rows` rows needs: two
    operations a multiply-add of the rows' t*numbase*d1 coefficients with
    the n0+1 columns of each of the four KSK limbs; the four limbs read
    once, the rows [rows, d1+1] int32 read once and the output [rows,
    n0+1] int32 written once."""
    kp = params.ks
    d1 = params.lvl1.k * params.lvl1.n
    cols = params.lvl0.dim + 1
    K = kp.t * kp.numbase * d1
    ops = 2 * rows * K * cols * 4
    nbytes = 4 * K * cols + 4 * rows * (d1 + 1) + 4 * rows * cols
    return ops, nbytes


def random_case(params, rows: int, seed: int, device):
    """(tlwe1 [rows, d1+1] int32, a KSK in ksk_tiles' layout), random, on
    `device`."""
    from ..ops.keyswitch import ksk_tiles
    from ..torus import from_u32
    kp = params.ks
    d1 = params.lvl1.k * params.lvl1.n
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (rows, d1 + 1), dtype=np.uint64)
    limbs = torch.from_numpy(rng.integers(
        -128, 128, (4, kp.t * kp.numbase * d1, params.lvl0.dim + 1),
        dtype=np.int8)).to(device)
    return from_u32(x.astype(np.uint32), device), ksk_tiles(limbs, params)


def measure(params, rows: int, launches: int, seed: int = 7) -> dict:
    """One case: bit-exact against the plain version, then the kernel's
    warm and cold medians and the plain version's."""
    from ..ops import keyswitch as KS
    from ..utils.timing import time_fn
    x, tiles = random_case(params, rows, seed, "cuda")
    if not torch.equal(KS.key_switch_cuda(x, tiles, params),
                       KS.key_switch_ref(x, tiles, params)):
        raise AssertionError(f"keyswitch_kernel differs from key_switch_ref "
                             f"at {params.name}, {rows} rows")
    ops, nbytes = ks_work(params, rows)
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    row_tile, split = KS.ks_plan(rows, params)
    rec = {"params": params.name, "rows": rows, "launches": launches,
           "row_tile": row_tile, "split": split, "ops": ops,
           "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": "ops" if ops_ms >= bytes_ms else "bytes"}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for name, between in (("warm", None), ("cold", flush.zero_)):
        ms = time_fn(KS.key_switch_cuda, x, tiles, params, iters=launches,
                     between=between, sleep_cycles=SLEEP_CYCLES) * 1e3
        rec[f"{name}_ms"] = ms
        rec[f"{name}_share_of_bound"] = bound_ms / ms
    rec["plain_ms"] = time_fn(KS.key_switch_ref, x, tiles, params,
                              iters=YARDSTICK_LAUNCHES) * 1e3
    return rec


def main() -> int:
    from ..params import PRESETS
    from ._common import device_record, require_cuda
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default="tfhepp_128bit,concrete")
    ap.add_argument("--rows", default="48,160,480,4096")
    ap.add_argument("--launches", type=int, default=25)
    args = ap.parse_args()
    dev = device_record()
    for name in args.params.split(","):
        for rows in (int(r) for r in args.rows.split(",")):
            rec = measure(PRESETS[name], rows, args.launches)
            print(json.dumps({**rec, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
