"""Entry point of the benchmark: python3 kmerbench/run.py --workload W
--seed N --seconds S --trace 0|1, from the root of a checkout."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if os.path.dirname(os.path.abspath(__file__)) in sys.path:
    sys.path.remove(os.path.dirname(os.path.abspath(__file__)))

from kmerbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
