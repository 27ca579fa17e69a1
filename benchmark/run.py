"""The benchmark of mpmcxx_tpu_torch on one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the cell's result as the last line of standard output, one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` with ``--trace 1``, then ``checks``: each number compared
beside its limit, which also end standard error).  Exits 2 without the
CUDA devices the cell asks for, 3 if JAX or the JAX package was loaded,
1 on any other failure, and prints no result then.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.cache_env(ROOT)
    sys.exit(harness.main(t_start=T_START))
