"""Run one cell of ``BENCHMARK.json`` once on the card:

    python benchmark/run.py --workload c1024.solve --seed 7 --seconds 20 --trace 0

See ``benchmark/lbmbench/harness.py``.
"""

import time

STARTED = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from lbmbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(started=STARTED, root=HERE.parent))
