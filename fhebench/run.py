"""Run one cell of BENCHMARK.json once and print its result:

    python3 fhebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (cufhe_tpu_torch). The
last line of standard output is one JSON object; the numbers compared to
decide `correct`, each beside its limit, are the last lines of standard
error. Exits 2 without the CUDA devices the cell asks for.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from fhebench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
