#!/usr/bin/env python3
"""Run one cell of the port's benchmark once (see portbench/harness.py).

    python3 portbench/run.py --workload socp_n6.b131072 --seed 7 \\
        --seconds 20 --trace 0

Needs a CUDA card; exits 2 without one, and prints no result.  Build and
kernel caches stay inside the checkout, under build/ (which git ignores):
the program's nvcc libraries in build/kernels/, and any PyTorch extension
or Triton cache in build/portbench_cache/.  The CPU thread pools get one
thread each.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
# one host thread for the CPU thread pools: the work is on the card, and
# with the pools at their default the loop cells ran about 7 % slower on
# the card's shared host (PERF.md section 2)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_process=T_PROCESS))
