"""The whole blind rotation on the card (the kernels of
ops.blind_rotate.blind_rotate_cuda: rotdec_kernel and extprod_kernel, n0
steps) at each key precision and Karatsuba depth: the exact four-limb key at every depth from the set's
own (ops.blind_rotate.kar_depth) down to 0, and the reduced-precision
`pallas3` three-limb key (depth 0), each beside the least time the card
could take for the rotation and one library product of the schoolbook
shape per step.

    python -m cufhe_tpu_torch.benchmarks.rotation [--params tfhepp_128bit]
        [--batch 4096] [--reps 2]
    python -m cufhe_tpu_torch.benchmarks.rotation --paths
        [--rows 1,48,160,480,2048] [--params tfhepp_128bit] [--reps 3]

All cases run on the same random accumulators and uint32 key, once each,
then timed with CUDA events (utils.timing.time_fn), one rotation a pair,
in turns (each case once, then in reverse order, `reps` times); the
median is reported. One more rotation of each case runs under
torch.profiler for the device time of each kernel a launch: the product
(extprod_kernel) beside the bound a launch, and rotdec_kernel. The bound
is fhebench/roofline.py's count, fixed whatever implements the product
(two levels of Karatsuba), so no case reads above 100 %. Prints one JSON
line per case with the card's name and power limit; exits 2 without a
CUDA device.

--paths times the two launches of the exact rotation at the set's own
depth beside each other at each row count (measure_paths): the loop of
2 n0 launches (rotdec_kernel, extprod_kernel) and the one persistent
launch (persistent_extprod_kernel, ops.blind_rotate.rotation_plan's grid,
or the card's SM count where the plan takes the loop), in turns, as time
a step against the bound a step, with the plain version's time and which
launch rotation_plan takes there; each case is first held equal to the
other launch.
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

#: two levels of Karatsuba: 9 of 16 schoolbook products (the count of
#: fhebench/roofline.py)
KARATSUBA2 = 9 / 16


def cases(params) -> list:
    """(key limbs, Karatsuba depth) of each timed case, in order: four
    limbs at the set's depth down to 0, then three limbs where the
    pallas3 path runs (N >= 128)."""
    from ..ops.blind_rotate import PALLAS3_MIN_N, kar_depth
    out = [(4, d) for d in range(kar_depth(params), -1, -1)]
    if params.lvl1.n >= PALLAS3_MIN_N:
        out.append((3, 0))
    return out


def rotation_work(params, rows: int, nlimbs: int = 4):
    """(int8 MACs, bytes each read or written once) of one blind rotation
    of `rows` accumulators with an `nlimbs`-limb key, as
    fhebench/roofline.py counts them whatever implements the product:
    (k+1) l digit polynomials (one int8 a gadget digit) x (k+1) output
    polynomials x N^2 coefficient products x nlimbs x 9/16 a row and step;
    acc read and written, abar read, the uint32 key read once."""
    lp = params.lvl1
    n0, N, kp1 = params.lvl0.dim, lp.n, lp.k + 1
    macs = (float(rows) * kp1 * lp.l * kp1 * N * N * nlimbs * KARATSUBA2
            * n0)
    nbytes = (2 * rows * kp1 * N * 4 + n0 * rows * 4
              + n0 * kp1 * lp.l * kp1 * N * 4)
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


def random_keys(params, seed: int, device, todo) -> dict:
    """{(limbs, depth): bk_ext} of one random BK [n0, (k+1)l, k+1, N] at
    each (key limbs, Karatsuba depth) of `todo`, built on `device` (no key
    generation: the kernels' time and parity need only the layout)."""
    from ..ops.blind_rotate import prepare_bk_ext
    from ..torus import from_u32
    lp = params.lvl1
    bk = from_u32(np.random.default_rng(seed).integers(
        0, 1 << 32, (params.lvl0.dim, (lp.k + 1) * lp.l, lp.k + 1, lp.n),
        dtype=np.uint64).astype(np.uint32), device)
    return {case: prepare_bk_ext(bk, params, *case) for case in todo}


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
    """One record per case of cases(params) at `rows` accumulators: its
    median ms a rotation over 2*reps timed rotations, int8 TMAC/s of the
    bound's count, bound and library time; and from one profiled
    rotation, the product's ms a launch against the bound a launch, and
    rotdec_kernel's. The cases' results are checked equal to the first
    four-limb case's (three limbs: to each other only)."""
    from ..ops import blind_rotate as BR
    todo = cases(params)
    acc, abar = random_rotation_inputs(params, rows, seed, "cuda")
    keys = random_keys(params, seed + 1, "cuda", todo)

    def run(case):
        return BR._blind_rotate_cuda(acc, abar, keys[case], params, case[1])

    first = run(todo[0])
    for case in todo[1:]:
        if case[0] == todo[0][0] and not torch.equal(run(case), first):
            raise AssertionError(f"{params.name}: depth {case[1]} differs "
                                 f"from depth {todo[0][1]}")
    del first
    torch.cuda.synchronize()
    times = {case: [] for case in todo}
    for _ in range(reps):
        for case in todo + todo[::-1]:
            times[case].append(time_fn(run, case, iters=1, warmup=0) * 1e3)
    n0 = params.lvl0.dim
    recs = []
    for (nl, depth), ts in times.items():
        ms = statistics.median(ts)
        macs, nbytes = rotation_work(params, rows, nl)
        bound_ms, bound_by = bound(2 * macs, nbytes)
        prof = profile_launches(lambda: run((nl, depth)))
        launch_ms = prof["product"][0] / max(prof["product"][1], 1)
        recs.append({"params": params.name, "rows": rows, "nlimbs": nl,
                     "depth": depth, "ms": ms, "ms_reps": ts,
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


def measure_paths(params, rows_list, reps: int = 3, seed: int = 50) -> list:
    """One record per row count: the loop's and the persistent kernel's
    median ms a rotation over 2*reps timed rotations in turns (CUDA
    events), each a step (over n0) beside the bound a step, the plain
    version's ms (one rotation), and the launch rotation_plan takes."""
    from .._build import sms
    from ..ops import blind_rotate as BR
    from ..ops.limbs import decomp_digit_limb_plan
    depth = BR.kar_depth(params)
    key = random_keys(params, seed + 1, "cuda", [(4, depth)])[(4, depth)]
    lp = params.lvl1
    I = (lp.k + 1) * lp.l * decomp_digit_limb_plan(lp.Bgbit)[0]
    cards = sms(torch.device("cuda"))
    n0 = params.lvl0.dim
    recs = []
    for rows in rows_list:
        acc, abar = random_rotation_inputs(params, rows, seed, "cuda")
        split, grid = BR.rotation_plan(rows, lp.n, lp.k + 1, I, cards, depth)
        launch = {"loop": 0, "persistent": grid or cards}

        def run(name):
            return BR._blind_rotate_cuda(acc, abar, key, params, depth,
                                         grid=launch[name])

        if not torch.equal(run("loop"), run("persistent")):
            raise AssertionError(f"{params.name}, {rows} rows: the "
                                 f"persistent rotation differs from the loop")
        times = {name: [] for name in launch}
        for _ in range(reps):
            for name in ("loop", "persistent", "persistent", "loop"):
                times[name].append(time_fn(run, name, iters=1, warmup=0)
                                   * 1e3)
        macs, nbytes = rotation_work(params, rows)
        bound_ms, bound_by = bound(2 * macs, nbytes)
        plain_ms = time_fn(BR.blind_rotate_ref, acc, abar, key, params,
                           iters=1, warmup=0) * 1e3
        rec = {"params": params.name, "rows": rows, "depth": depth,
               "split": split, "grid": grid,
               "takes": "persistent" if grid else "loop",
               "bound_us_a_step": 1e3 * bound_ms / n0, "bound_by": bound_by,
               "plain_ms": plain_ms}
        for name, ts in times.items():
            ms = statistics.median(ts)
            rec[f"{name}_ms"] = ms
            rec[f"{name}_us_a_step"] = 1e3 * ms / n0
            rec[f"{name}_share_of_bound"] = bound_ms / ms
        rec["persistent_over_loop"] = rec["persistent_ms"] / rec["loop_ms"]
        recs.append(rec)
    return recs


def main() -> int:
    from ..params import PRESETS
    from ._common import device_record, require_cuda
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", default="tfhepp_128bit")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--paths", action="store_true",
                    help="the loop against the persistent kernel a step")
    ap.add_argument("--rows", default="1,48,160,480,2048",
                    help="row counts of --paths")
    args = ap.parse_args()
    dev = device_record()
    recs = (measure_paths(PRESETS[args.params],
                          [int(r) for r in args.rows.split(",")],
                          max(args.reps, 1))
            if args.paths else
            measure(PRESETS[args.params], args.batch, args.reps))
    for rec in recs:
        print(json.dumps({**rec, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
