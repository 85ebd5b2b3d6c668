"""The whole blind rotation on the card (ops.blind_rotate.blind_rotate_cuda:
rotdec_kernel and extprod_kernel, n0 steps) at each key precision: the
exact four-limb key and the reduced-precision `pallas3` three-limb key,
each beside the least time the card could take for its int8
multiply-adds and one library product of the same shape per step.

    python -m cufhe_tpu_torch.benchmarks.rotation [--params tfhepp_128bit]
        [--batch 4096] [--reps 2]

Both run on the same random accumulators and key (limbs 1-3 of the
four-limb key are the three-limb key), once each, then timed with CUDA
events (utils.timing.time_fn), one rotation a pair, in turns (each
precision once, then in reverse order, `reps` times); the median is
reported. One more rotation at each precision runs under torch.profiler
for the device time of each kernel a launch: the product
(extprod_kernel) beside its int8 bound a launch, and rotdec_kernel.
Prints one JSON line per precision with the card's name and power limit;
exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops.limbs import decomp_digit_limb_plan
from ..utils.timing import time_fn
from ._common import HBM_BYTES_PER_S, INT8_OPS_PER_S

#: key limb counts, in the order timed
CASES = (4, 3)


def rotation_work(params, rows: int, nlimbs: int = 4):
    """(int8 MACs, bytes each read or written once) of one blind rotation
    of `rows` accumulators with an `nlimbs`-limb key: acc in and out,
    abar, the key."""
    lp = params.lvl1
    n0, N, kp1 = params.lvl0.dim, lp.n, lp.k + 1
    I = kp1 * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    macs = float(rows) * (I * N) * (kp1 * nlimbs * N) * n0
    nbytes = (2 * rows * kp1 * N * 4 + n0 * rows * 4
              + n0 * I * kp1 * nlimbs * 2 * N)
    return macs, nbytes


def bound(ops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the least time the card could take
    for `ops` int8 operations moving `nbytes` bytes of device memory, at
    the H100's data-sheet rates."""
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def random_rotation_inputs(params, rows: int, seed: int, device):
    """Random accumulators [rows, k+1, N] and rotations abar [n0, rows]."""
    from ..torus import from_u32
    rng = np.random.default_rng(seed)
    lp = params.lvl1
    acc = rng.integers(0, 1 << 32, (rows, lp.k + 1, lp.n), dtype=np.uint64)
    abar = rng.integers(0, 2 * lp.n, (params.lvl0.dim, rows))
    return (from_u32(acc.astype(np.uint32), device),
            from_u32(abar.astype(np.uint32), device))


def random_keys(params, seed: int, device, limbs=(4, 3)) -> dict:
    """{limbs: bk_ext} of one random BK [n0, (k+1)l, k+1, N] at each of
    `limbs` (no key generation: the kernels' time and parity need only
    the layout)."""
    from ..ops.blind_rotate import prepare_bk_ext
    lp = params.lvl1
    bk = np.random.default_rng(seed).integers(
        0, 1 << 32, (params.lvl0.dim, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
        dtype=np.uint64).astype(np.uint32)
    return {nl: torch.from_numpy(prepare_bk_ext(bk, params, nl)).to(device)
            for nl in limbs}


def library_ms(params, rows: int, nlimbs: int, iters: int = 5) -> float:
    """ms of torch._int_mm at one step's product shape, [rows, I*N] @
    [I*N, (k+1)*nlimbs*N], times n0: a yardstick the port never calls."""
    lp = params.lvl1
    I = (lp.k + 1) * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    a8 = torch.randint(-128, 128, (rows, I * lp.n), dtype=torch.int8,
                       device="cuda")
    b8 = torch.randint(-128, 128, (I * lp.n, (lp.k + 1) * nlimbs * lp.n),
                       dtype=torch.int8, device="cuda")
    return (time_fn(torch._int_mm, a8, b8, iters=iters) * 1e3
            * params.lvl0.dim)


def profile_launches(run) -> dict:
    """{"product": [ms, launches], "rotdec": [ms, launches]}: the device
    time of the two kernels in one call of `run` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {"product": [0.0, 0], "rotdec": [0.0, 0]}
    for e in prof.events():
        name = ("product" if "extprod_kernel" in e.name
                else "rotdec" if "rotdec_kernel" in e.name else None)
        if name and e.device_type == DeviceType.CUDA:
            out[name][0] += e.device_time_total / 1e3
            out[name][1] += 1
    return out


def measure(params, rows: int, reps: int = 2, seed: int = 40) -> list:
    """One record per key precision of CASES at `rows` accumulators: its
    median ms a rotation over 2*reps timed rotations, int8 TMAC/s, bound
    and library time; and from one profiled rotation, the product's ms a
    launch against its bound a launch, and rotdec_kernel's."""
    from ..ops import blind_rotate as BR
    acc, abar = random_rotation_inputs(params, rows, seed, "cuda")
    keys = random_keys(params, seed + 1, "cuda")

    def run(nl):
        return BR.blind_rotate_cuda(acc, abar, keys[nl], params)

    for nl in CASES:
        run(nl)
    torch.cuda.synchronize()
    times = {nl: [] for nl in CASES}
    for _ in range(reps):
        for nl in CASES + CASES[::-1]:
            times[nl].append(time_fn(run, nl, iters=1, warmup=0) * 1e3)
    n0 = params.lvl0.dim
    recs = []
    for nl, ts in times.items():
        ms = statistics.median(ts)
        macs, nbytes = rotation_work(params, rows, nl)
        bound_ms, bound_by = bound(2 * macs, nbytes)
        prof = profile_launches(lambda: run(nl))
        launch_ms = prof["product"][0] / max(prof["product"][1], 1)
        recs.append({"params": params.name, "rows": rows, "nlimbs": nl,
                     "ms": ms, "ms_reps": ts,
                     "tmacs_per_sec": macs / ms / 1e9, "macs": macs,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "share_of_bound": bound_ms / ms,
                     "library_ms": library_ms(params, rows, nl),
                     "product_ms_a_launch": launch_ms,
                     "product_launches": prof["product"][1],
                     "product_tmacs_per_sec": macs / n0 / launch_ms / 1e9,
                     "product_share_of_bound": bound_ms / n0 / launch_ms,
                     "rotdec_us_a_launch": 1e3 * prof["rotdec"][0]
                     / max(prof["rotdec"][1], 1)})
    return recs


def main() -> int:
    from ..params import PRESETS
    from ._common import device_record, require_cuda
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    dev = device_record()
    for rec in measure(PRESETS[args.params], args.batch, args.reps):
        print(json.dumps({**rec, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
