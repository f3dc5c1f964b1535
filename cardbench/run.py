"""Run one cell of the benchmark once, from the root of a checkout:

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of its standard output (see
README.md).  Set-up is timed from the first line of this file on."""
import time

STARTED = time.time()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == '__main__':
    # The checkout's root, not this folder, heads the path: the folder's
    # module names (trace, stats) would hide the standard library's.
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from cardbench.harness import main

    sys.exit(main(sys.argv[1:], STARTED))
