"""The benchmark's command:

    python3 vqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line on standard output (the
last), the numbers the check compared on standard error (the last lines).
Exits 2 without the CUDA cards the cell asks for, non-zero with no result
on any other failure."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# any compiler cache of a library the program loads stays in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "vqbench", "results", "triton"))
sys.path[0] = ROOT  # the checkout, not this directory

from vqbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T0))
