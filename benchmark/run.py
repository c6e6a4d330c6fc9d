"""Run one cell of the benchmark once and print its result:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells are listed in BENCHMARK.json; see
benchmark/harness.py for what a run does and where a cell's files are. The
program builds its one CUDA kernel into its own fixed folder inside the
checkout (cosmoprimo_tpu_torch/_build/), so only a checkout's first run
compiles.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT          # the checkout, not this folder

from benchmark import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(sys.argv[1:], T0))
