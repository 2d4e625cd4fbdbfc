"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cells, metrics and bounds are in ``BENCHMARK.json``; the
harness is ``bench/harness``, the configurations, traffic mixes, limits
and per-layer readers the files under ``bench/`` that it finds by name.
The program measured is ``src/repro_torch``; nothing here imports JAX or
the JAX package.  The last line of standard output is one JSON object;
a run that cannot give a result exits non-zero and prints none.
"""
import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at
# fixed paths, so only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]

from harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
