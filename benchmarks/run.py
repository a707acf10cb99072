"""Run one cell of the benchmark once and print its result as the last line.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``voicebridge_tpu_torch``); see ``benchmarks/README.md``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for entry in (str(HERE.parent), str(HERE)):
    if entry not in sys.path:
        sys.path.insert(0, entry)

from vbbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
