"""Ideal (minimum) memory requirement calculator (NNTrainer §3, Table 4).

The *ideal* requirement is the peak, over the execution-order timeline, of
the sum of bytes of all simultaneously-live tensors (after MV/RV/E merging)
plus externally-held placeholders (inputs/labels stay resident for the whole
iteration).  A planner with zero fragmentation achieves exactly this number;
the paper's Fig. 9 compares measured peaks against it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.execution_order import OrderedTensors, compute_execution_order
from repro_torch.core.graph import LayerGraph
from repro_torch.core.lifespan import CreateMode


@dataclasses.dataclass
class IdealMemory:
    arena_bytes: int        # peak live CREATE-tensor bytes (perfect packing)
    external_bytes: int     # placeholders (input/label)
    weight_bytes: int       # subset of arena: Max-lifespan tensors
    activation_bytes: int   # subset at peak: saved activations

    @property
    def total_bytes(self) -> int:
        return self.arena_bytes + self.external_bytes

    @property
    def total_kib(self) -> float:
        return self.total_bytes / 1024.0


def ideal_memory(graph: LayerGraph, batch: int) -> IdealMemory:
    ordered = compute_execution_order(graph, batch)
    return ideal_from_ordered(ordered)


def ideal_from_ordered(ordered: OrderedTensors) -> IdealMemory:
    planned = ordered.planned_tensors()
    external = sum(
        t.nbytes for t in ordered.tensors.values()
        if t.create_mode == CreateMode.PLACEHOLDER
    )
    events = sorted({t.min_eo for t in planned} | {t.max_eo for t in planned})
    peak = 0
    peak_t = 0
    for ts in events:
        live = sum(t.nbytes for t in planned if t.min_eo <= ts <= t.max_eo)
        if live > peak:
            peak, peak_t = live, ts
    weight = sum(t.nbytes for t in planned if t.name.startswith("W:"))
    act_at_peak = sum(
        t.nbytes for t in planned
        if t.min_eo <= peak_t <= t.max_eo and t.name.startswith("X:")
    )
    return IdealMemory(
        arena_bytes=peak,
        external_bytes=external,
        weight_bytes=weight,
        activation_bytes=act_at_peak,
    )


# Paper Table 4 published ideal sizes (KiB) at batch 64, for validation.
PAPER_TABLE4_KIB: Dict[str, float] = {
    "linear": 49397,
    "conv2d": 65856,
    "lstm": 84731,
    "model_a_linear": 188250,
    "model_a_conv2d": 51157,
    "model_b_linear": 112935,
    "model_b_conv2d": 54097,
    "model_c_linear": 49399,
    "model_c_conv2d": 65856,
    "model_d": 162295,
}
