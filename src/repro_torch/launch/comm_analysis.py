"""Collective traffic of a sharded step: per-kind tallies.

The counterpart of ``repro/launch/hlo_analysis.py``.  The reference reads
its collectives off the compiled, partitioned HLO; here every collective
of the port goes through ``repro_torch.sharding.collectives``, which
tallies each call's kind, operand bytes and result bytes as it runs, so
the analysis reads the tally of the calls a step made:

* all-gather: operand = this rank's block, result = the gathered tensor;
* all-reduce: operand = result = the tensor (float32 for a bf16 sum);
* reduce-scatter: operand = the whole tensor, result = this rank's block;
* collective-permute: operand = result = what this rank sent;
* all-to-all: none of the port's steps makes one (count 0).

Operand bytes approximate what leaves a device, as the reference counts
them.  Counts and bytes are this rank's.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.sharding import collectives as C

COLLECTIVE_OPS = C.KINDS


def analyze_collectives(tally: Optional[Dict] = None) -> Dict:
    """The reference's keys over ``tally`` (default: the module's tally
    since its last reset): ``per_op`` (kind -> count, operand_bytes,
    result_bytes), ``collective_operand_bytes``, ``collective_result_bytes``
    and ``collective_bytes`` (the larger of the two)."""
    tally = C.tally() if tally is None else tally
    per_op = {op: dict(tally.get(op, {"count": 0, "operand_bytes": 0,
                                      "result_bytes": 0}))
              for op in COLLECTIVE_OPS}
    operand = sum(d["operand_bytes"] for d in per_op.values())
    result = sum(d["result_bytes"] for d in per_op.values())
    return {"per_op": per_op, "collective_operand_bytes": operand,
            "collective_result_bytes": result,
            "collective_bytes": max(operand, result)}
