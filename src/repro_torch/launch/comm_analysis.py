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
them.  Counts and bytes are this rank's.  Given the step's records
(``collectives.record_calls``), ``per_axis`` splits them by the mesh
axis (or axes, joined by ``+``) each ran over: a pod mesh's ``pod``
traffic apart from its ``data`` and ``model`` traffic.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.sharding import collectives as C

COLLECTIVE_OPS = C.KINDS


def axis_key(axis) -> str:
    """A collective's axis as ``per_axis`` keys it: the name, or the
    names of a tuple joined by ``+``."""
    return axis if isinstance(axis, str) else "+".join(axis)


def per_axis(calls: List[dict]) -> Dict[str, Dict[str, Dict[str, int]]]:
    """axis -> kind -> count, operand and result bytes of ``calls``
    (``collectives.record_calls``' records)."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for c in calls:
        d = out.setdefault(axis_key(c["axis"]), {}).setdefault(
            c["kind"], {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        d["count"] += 1
        d["operand_bytes"] += c["operand_bytes"]
        d["result_bytes"] += c["result_bytes"]
    return out


def analyze_collectives(tally: Optional[Dict] = None,
                        calls: Optional[List[dict]] = None) -> Dict:
    """The reference's keys over ``tally`` (default: the module's tally
    since its last reset): ``per_op`` (kind -> count, operand_bytes,
    result_bytes), ``collective_operand_bytes``, ``collective_result_bytes``
    and ``collective_bytes`` (the larger of the two); given the same
    collectives' records, ``per_axis`` too."""
    tally = C.tally() if tally is None else tally
    per_op = {op: dict(tally.get(op, {"count": 0, "operand_bytes": 0,
                                      "result_bytes": 0}))
              for op in COLLECTIVE_OPS}
    operand = sum(d["operand_bytes"] for d in per_op.values())
    result = sum(d["result_bytes"] for d in per_op.values())
    out = {"per_op": per_op, "collective_operand_bytes": operand,
           "collective_result_bytes": result,
           "collective_bytes": max(operand, result)}
    if calls is not None:
        out["per_axis"] = per_axis(calls)
    return out
