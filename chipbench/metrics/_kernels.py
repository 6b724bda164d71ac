"""A kernel's share of its roofline, shared by the ``*_roofline`` readers:
the launches the program counted in the traced window, checked against the
count the model's structure implies (each layer's forward, and at most
once more in its checkpoint's replay), times the least time one launch at
the cell's shapes needs (``chipbench/yardstick.py``), over the device time
of that kernel's names in the trace."""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Tuple

from chipbench import yardstick


def rows_per_micro(ctx: Dict) -> int:
    return ctx["sequences"] // ctx["microbatches"]


def roofline(ctx: Dict, kernel: str, names: Sequence[str],
             cost: Tuple[int, int], dtype: str, forward_per_micro: int
             ) -> Optional[float]:
    tr = ctx.get("trace")
    if not tr or not ctx["cuda"] or ctx["card"] not in yardstick.PEAKS:
        return None
    n = ctx["launches"].get(kernel, 0)
    fwd = forward_per_micro * ctx["microbatches"] * ctx["steps_traced"]
    if n == 0 or fwd == 0:
        return None
    if n % fwd or n // fwd not in (1, 2):
        print(f"{kernel}: {n} launches, not {fwd} forwards with or without "
              "a replay each: no roofline", file=sys.stderr)
        return None
    t = sum(s for k, s in tr["kernels"].items()
            if any(p in k for p in names))
    if t <= 0:
        return None
    return 100 * n * yardstick.bound_ms(*cost, dtype, ctx["card"]) / 1e3 / t
