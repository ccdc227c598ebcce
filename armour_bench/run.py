"""Run one cell of ``BENCHMARK.json`` once, on the card:

    python3 armour_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m armour_bench.run`` works the same).  Prints the result as
the last line of standard output and the numbers the correctness check
compared, each beside its limit, as the last lines of standard error.
Exits non-zero, with no result, without enough CUDA devices for the cell
or where modules of JAX or the JAX package were loaded.
"""

import time

T_PROC = time.perf_counter()   # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from armour_bench.harness import main

    sys.exit(main(sys.argv[1:], T_PROC))
