"""The readings that the limits of `correct` are set from: a cell run on
several seeds in one process, by the exact path (the program as the
configuration states it) or by the control (the program's reduced-precision
`pallas3` path, a three-limb key in place of the four-limb one).

    python3 fhebench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--backend pallas3]

Prints one JSON line per seed with the numbers compared and `correct`.
Needs the card; the benchmark's own runs never run this.
"""
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import argparse

    import torch

    from fhebench import harness as H

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    cell = H.Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = H.run_cell(cell, seed, args.seconds, False, "cuda",
                         time.perf_counter(), args.backend)
        print(json.dumps({"workload": cell.name, "backend": args.backend,
                          "seed": seed, "correct": res["correct"],
                          "steps": res["steps"], "checks": res["checks"],
                          "check_s": res["check_s"]}), flush=True)
