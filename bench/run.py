"""Run one cell of the benchmark once.

    python bench/run.py --workload W --seed N --seconds S --trace 0|1

from the root of the repository.  Prints the result as one JSON line, the
last line of standard output; the numbers compared with the reference
and their limits are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
# the checkout's root in place of this file's folder, then the port
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
