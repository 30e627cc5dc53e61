"""Run one cell of the benchmark of ``nemo_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for.  The last line of standard output is the result, a JSON object;
without a card the run exits 2 and prints none."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, not this directory, heads the import path: the
# benchmark is the package ``portbench`` beside the program.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
