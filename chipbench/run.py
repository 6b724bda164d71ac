"""Run one cell of the port's benchmark and print its result line.

    python chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell
asks for.  The port's kernels build into ``build/`` inside the checkout,
so only a checkout's first run compiles.  Exits non-zero with no result
without a CUDA card, with fewer cards than the cell needs, when a module
of JAX or of the JAX package is loaded, or when a file the run needs is
missing.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for path in (ROOT / "src", ROOT):
    sys.path.insert(0, str(path))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)

from chipbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
