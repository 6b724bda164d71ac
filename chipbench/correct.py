"""The comparison that decides ``correct`` for a training cell.

The program's first train steps and the reference's, from the same
weights on the same batches, give three readings each: every step's loss,
every parameter's gradient norm at the first step (the program's as its
optimizer got it, worked out from the AdamW state after one step:
m / (1 - b1)), and every parameter's change ||p - p0|| after the steps.
Three numbers compare them:

* ``loss_gap``: the largest |program - reference| / |reference| over the
  steps' losses;
* ``grad_norm_gap``: over the parameters, the largest gap between the two
  gradient norms, over the larger of the reference's norm of that
  parameter and the median parameter's;
* ``change_norm_gap``: the same for the change after the steps, over the
  parameters that the reference's first gradient moves: one whose
  gradient is under a thousandth of the median parameter's (a padded row
  of the vocabulary, a bias the softmax cancels) moves under AdamW by
  round-off and weight decay alone, and is left out by that rule, not by
  name.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

STILL = 1e-3          # a gradient under this share of the median's


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           names: List[str]) -> Tuple[float, str]:
    if not names:
        return 0.0, ""
    floor = statistics.median(ref[n] for n in names)
    worst, at = -1.0, ""
    for n in names:
        gap = abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], floor, 1e-30)
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst:
            worst, at = gap, n
    return worst, at


def numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} of the program's readings against the
    reference's."""
    steps = min(len(prog["losses"]), len(ref["losses"]))
    loss = max((abs(prog["losses"][i] - ref["losses"][i])
                / abs(ref["losses"][i]) for i in range(steps)),
               default=math.inf)
    if not math.isfinite(loss):
        loss = math.inf
    g_ref = ref["first_grad_norms"]
    names = sorted(g_ref)
    grad = _worst(prog["first_grad_norms"], g_ref, names)
    med = statistics.median(g_ref.values())
    moved = [n for n in names if g_ref[n] >= STILL * med]
    change = _worst(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": (loss, f"step {steps}"),
            "grad_norm_gap": grad, "change_norm_gap": change}


def judge(prog: Dict, ref: Dict, limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, Dict[str, Dict], List[str]]:
    """(correct, {number: {"value", "limit"}}, lines for standard error).
    A number whose limit is None is reported and not compared."""
    found = numbers(prog, ref)
    ok = all(math.isfinite(v) for v in prog["losses"])
    checks, lines = {}, []
    for name, (value, where) in found.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        passed = limit is None or value <= limit
        ok = ok and passed
        lines.append(f"{name} {value!r} limit {limit!r} "
                     f"{'ok' if passed else 'FAILED'} (worst: {where})")
    return ok, checks, lines
