"""Batch-size buckets and the shared compile cache.

Port of ``repro/serve/buckets.py``.  The serving cost model: compiling a
memory plan (EO analysis -> offload schedule -> arena packing ->
co-optimisation -> verification) is the expensive step, and it is keyed
only by ``(graph, batch shape, planner config, arena budget)`` — never by
*whose* data flows through it.  So the service quantises request sizes to
a small sorted set of buckets, pads short batches up to the bucket with
masked rows, and shares one
:class:`~repro_torch.core.CompiledMemoryPlan` per key across every tenant.

Padding is numerically exact, not approximate: the sample mask zeroes the
loss derivative of pad rows at the source, and because no zoo graph mixes
samples across the batch dimension (batchnorm is the only layer that
would), gradients from a padded bucket match the unpadded batch bit-for-
bit modulo float reassociation (gated at 1e-4 in tests).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import (CompiledMemoryPlan, MemoryPlanConfig,
                              compile_plan, compile_plan_under_budget)
from repro_torch.core.graph import LOSS_KINDS, LayerGraph
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------

def choose_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket that fits ``n`` samples, or None when ``n`` exceeds
    every bucket (the request must be rejected or split by the caller)."""
    if n <= 0:
        return None
    for b in sorted(buckets):
        if n <= b:
            return b
    return None


def pad_to_bucket(x: Tensor, y: Tensor, bucket: int,
                  ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Zero-pad ``(x, y)`` up to ``bucket`` rows; returns ``(x, y, mask)``.

    ``mask`` is a float32 ``(bucket,)`` vector on ``x``'s device with 1.0
    on real rows and 0.0 on pad rows — feed it to
    ``CompiledMemoryPlan.loss_and_grads`` so the pad rows contribute
    exactly zero to the loss and every gradient.  A full batch returns the
    inputs untouched with ``mask=None`` (the unmasked path).
    """
    n = int(x.shape[0])
    if n == bucket:
        return x, y, None
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    pad = bucket - n
    xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    yp = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
    mask = torch.cat([torch.ones(n, dtype=torch.float32, device=x.device),
                      torch.zeros(pad, dtype=torch.float32,
                                  device=x.device)])
    return xp, yp, mask


def loss_kind(graph: LayerGraph) -> str:
    for l in graph.layers:
        if l.kind in LOSS_KINDS:
            return l.kind
    raise ValueError(f"graph {graph.name!r} has no loss layer")


def dummy_batch(graph: LayerGraph, bucket: int, *, seed: int = 0,
                device: DeviceLike = None) -> Tuple[Tensor, Tensor]:
    """Synthetic ``(x, y)`` at the bucket's full batch size, drawn from a
    ``torch.Generator`` seeded with ``seed`` and placed on ``device`` (the
    CUDA card when None), used to warm each bucket's plan before live
    traffic."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((bucket,) + tuple(graph.input_shape), generator=gen)
    yshape = (bucket,) + tuple(graph.label_shape)
    if loss_kind(graph) == "loss_ce":
        classes = yshape[-1]
        idx = torch.randint(0, classes, yshape[:-1], generator=gen)
        y = torch.nn.functional.one_hot(idx, classes).to(torch.float32)
    else:
        y = torch.randn(yshape, generator=gen)
    return x.to(dev), y.to(dev)


# ---------------------------------------------------------------------------
# The compile cache
# ---------------------------------------------------------------------------

class PlanCache:
    """``(model, bucket, planner config, arena budget) -> CompiledMemoryPlan``.

    The key includes every :class:`MemoryPlanConfig` field
    (``config.cache_key()``) *and* the arena byte budget, so two tenants
    whose QoS budgets differ can never share a plan even when every other
    knob matches — plan sharing is an optimisation, never an isolation
    leak.  ``hits``/``misses`` count live lookups; seeding a warm-up
    compile counts as the miss it is (a compile happened).
    """

    def __init__(self) -> None:
        self._plans: Dict[Tuple[Any, ...], CompiledMemoryPlan] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(graph: LayerGraph, bucket: int, config: MemoryPlanConfig,
            arena_budget_bytes: Optional[int]) -> Tuple[Any, ...]:
        return (graph.name, int(bucket), config.cache_key(),
                arena_budget_bytes)

    def get_or_compile(self, graph: LayerGraph, config: MemoryPlanConfig,
                       *, bucket: int,
                       arena_budget_bytes: Optional[int] = None,
                       ) -> CompiledMemoryPlan:
        """Return the cached plan for the key, compiling on first use.

        With a budget, compilation goes through
        :func:`repro_torch.core.compile_plan_under_budget` and may raise
        :class:`repro_torch.core.ArenaBudgetError` — the caller's admission
        signal.  A failed compile caches nothing.
        """
        k = self.key(graph, bucket, config, arena_budget_bytes)
        cp = self._plans.get(k)
        if cp is not None:
            self.hits += 1
            return cp
        self.misses += 1
        if arena_budget_bytes is None:
            cp = compile_plan(graph, config, batch=bucket)
        else:
            cp = compile_plan_under_budget(
                graph, config, batch=bucket,
                arena_budget_bytes=arena_budget_bytes)
        self._plans[k] = cp
        return cp

    def seed(self, graph: LayerGraph, bucket: int, config: MemoryPlanConfig,
             arena_budget_bytes: Optional[int],
             cp: CompiledMemoryPlan) -> None:
        """Install an already-compiled plan (warm-up probes) as a miss."""
        self._plans[self.key(graph, bucket, config, arena_budget_bytes)] = cp
        self.misses += 1

    def __len__(self) -> int:
        return len(self._plans)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def report(self) -> Dict[str, Any]:
        return {"entries": len(self._plans), "hits": self.hits,
                "misses": self.misses, "hit_rate": round(self.hit_rate(), 4)}
