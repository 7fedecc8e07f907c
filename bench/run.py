"""Run one cell of the port's benchmark:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line (the result) as the last
line of standard output; exits non-zero without it when the card is
missing, the program cannot be imported, or JAX was loaded.
"""
import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``bench``) and ``src`` (for the program), in
# place of this script's own directory, whose module names would shadow
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], STARTED))
