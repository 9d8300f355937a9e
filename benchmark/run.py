"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH_DIR, os.path.dirname(BENCH_DIR)]  # harness, the port

from harness import main  # noqa: E402

if __name__ == "__main__":
    main.set_cache_dirs()
    sys.exit(main.main(t_start=T_START))
