"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``check``, the numbers compared beside their limits);
the check's lines are the last lines of standard error. Exits non-zero,
with no result, without a card or with too few of them.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# every kernel cache at a fixed path inside the checkout; no library loads
# JAX or Flax behind the program's back
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
