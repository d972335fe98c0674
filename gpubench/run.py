"""Entry point of the benchmark (BENCHMARK.json's command):

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see gpubench/harness.py."""

import sys
from pathlib import Path

# the checkout's root, in place of this script's directory
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from gpubench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
