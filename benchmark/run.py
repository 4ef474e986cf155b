"""Run one benchmark cell once: see benchmark/README.md.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host's work is launching kernels, and
# idle pool threads only take cores from it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
