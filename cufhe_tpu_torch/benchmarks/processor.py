"""TOY8 encrypted processor on the card: encrypted-CPU cycles per second,
the counterpart of benchmarks/processor.py (same environment knobs).

Steps the TOY8 cycle circuit (fetch/decode/ALU/control: 296 gates over 22
levels, 177 of them mux) over a batch of lanes, each lane an independent
random program, and reports cycles/s, lane-cycles/s and effective
bootstraps/s (a mux counts 2 blind rotations, as the reference counts it,
test_gate_gpu.cc:43: 504 a lane-cycle). Every lane's final (ACC, PC) is
checked against the ISA interpreter, and the blind-rotation kernel
launches against the executor's plan times the cycles.

Env: PROC_BATCH (default 256), PROC_CYCLES (default 4),
     PROC_PARAMS (default tfhepp_128bit), PROC_SCAN=1 to run the cycles
     through runtime.run_schedule_loop (one register layout and step plan
     for the whole run) instead of run_schedule once per cycle.
     PROC_FUSED (whole-schedule fusion) is left out of the port and
     refused.

    python -m cufhe_tpu_torch.benchmarks.processor

Prints one JSON line with the card's name and power limit; needs a CUDA
device.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

#: blind rotations a gate costs (mux/nmux two, the linear gates none)
WEIGHT = {"mux": 2, "nmux": 2, "not": 0, "copy": 0}


def bootstraps_per_cycle(sched) -> int:
    """Effective bootstraps of one lane-cycle: a mux counts 2."""
    return sum(WEIGHT.get(op, 1) * len(q)
               for lvl in sched.levels for op, q in lvl)


def random_programs(rng, batch: int):
    """`batch` random TOY8 programs of 1-16 instructions."""
    from ..models import processor as TOY
    ops = list(TOY.OPCODES)
    return [[(ops[rng.integers(len(ops))], int(rng.integers(256)))
             for _ in range(int(rng.integers(1, TOY.PROG_SLOTS + 1)))]
            for _ in range(batch)]


def run(ctx, sk, sched, progs, cycles: int, scan: bool, seed: int = 5):
    """Encrypt `progs`, run `cycles` cycles (timed on the host clock to a
    synchronise, launches counted), decrypt and check every lane. Returns
    (final state Ctxts, record)."""
    from ..models import processor as TOY
    from ..runtime.executor import plan_rotations, schedule_steps
    from ..utils.spans import counts
    batch = len(progs)
    inputs = TOY.encrypt_state(progs, sk, np.random.default_rng(seed),
                               device=ctx.device)
    planned = plan_rotations(schedule_steps(ctx, sched, batch)) * cycles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = counts()["blind_rotate"]
    t0 = time.perf_counter()
    state = TOY.run_cycles(ctx, sched, inputs, cycles, scan=scan)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = counts()["blind_rotate"] - before
    acc, pc = TOY.decrypt_state(state, sk)
    errors = sum((int(acc[i]), int(pc[i])) != TOY.interpret(p, cycles)
                 for i, p in enumerate(progs))
    boots = bootstraps_per_cycle(sched) * cycles * batch
    return state, {
        "mode": "scan" if scan else "levels", "batch": batch,
        "cycles": cycles, "seconds": dt, "cycles_per_sec": cycles / dt,
        "lane_cycles_per_sec": cycles * batch / dt,
        "bootstraps_per_sec": boots / dt,
        "rotation_launches": launches, "planned_rotations": planned,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "lane_errors": int(errors)}


def main() -> int:
    from ._common import (device_record, load_or_make_bench_keys,
                          require_cuda)
    from .. import Context
    from ..models import processor as TOY
    from ..runtime.executor import precompile_schedule

    if os.environ.get("PROC_FUSED", "0") == "1":
        print("PROC_FUSED: whole-schedule fusion is left out of the port "
              "(every step is one eager call); use the default level "
              "executor or PROC_SCAN=1", file=sys.stderr)
        return 2
    require_cuda()
    batch = int(os.environ.get("PROC_BATCH", "256"))
    cycles = int(os.environ.get("PROC_CYCLES", "4"))
    pname = os.environ.get("PROC_PARAMS", "tfhepp_128bit")
    scan = os.environ.get("PROC_SCAN", "0") == "1"
    sk, ek = load_or_make_bench_keys(pname)
    params = ek.params

    sched = TOY.build_cycle()[0].compile()
    ctx = Context(ek)
    progs = random_programs(np.random.default_rng(5), batch)
    tc = time.perf_counter()
    shapes = precompile_schedule(ctx, sched, batch)
    compile_s = time.perf_counter() - tc
    print(f"precompiled {shapes} step shapes in {compile_s:.1f} s; stepping "
          f"the {sched.num_gates}-gate cycle circuit x {cycles} cycles x "
          f"batch {batch}...", file=sys.stderr)
    _, rec = run(ctx, sk, sched, progs, cycles, scan)
    rec = {"bench": "toy8_processor", "params": params.name,
           "gates_per_cycle": sched.num_gates, "levels": sched.num_levels,
           "bootstraps_per_lane_cycle": bootstraps_per_cycle(sched), **rec,
           "step_shapes": shapes, "precompile_seconds": compile_s,
           "device": device_record()}
    print(json.dumps(rec))
    bad = rec["lane_errors"] or \
        rec["rotation_launches"] != rec["planned_rotations"]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
