"""Unified memory-plan compile API: graph (or model config) -> executor.

NNTrainer's key property is that its memory optimisations are *transparent
to training algorithms*: the user declares a network, the framework derives
execution order, swap schedule and arena packing behind one compile step.
This module is that compile step for the reproduction.  Instead of
hand-wiring

    compute_execution_order -> plan_offload -> plan_memory_swapped
        -> plan_checkpoint_policy -> swap_planned_loss_and_grads

callers declare a :class:`MemoryPlanConfig` and call :func:`compile_plan`,
which runs the whole pipeline and returns a :class:`CompiledMemoryPlan` —
one object owning the schedule, the packed arenas, the remat/offload policy
and the executor entry point (``.loss_and_grads``).

Two input kinds are accepted:

* a :class:`repro_torch.core.graph.LayerGraph` — the layer-basis path: EO
  analysis, proactive-swap scheduling, swap-aware arena packing and the
  phase-ticked swap executor;
* a transformer-shaped ``ModelConfig`` — the model path: the joint
  keep/recompute/offload planner over tagged intermediates (its
  checkpoint-policy realisation comes with training, ROADMAP item 8).

Schedule/planner co-optimisation (ROADMAP item, now a behaviour of this
API): ``plan_offload`` picks swap candidates by byte-phase product *before*
packing, so some swaps vacate bytes the packer never needed — they pay two
DMA transfers and reclaim no packed peak.  After packing, the compile loop
drops every such non-load-bearing swap and re-plans, iterating to a fixed
point where (a) removing any remaining swap would raise the packed peak and
(b) the peak never exceeds the single-pass ``plan_memory_swapped`` result.
DMA traffic shrinks at equal peak — exactly the ``swap/vgg16`` diminishing-
returns observation.

The model-config path runs the same remat knapsack and swap scheduler as
*one* planner (ROADMAP's "swap the remat knapsack jointly"): every tagged
intermediate gets a three-way keep / recompute / offload decision priced by
the :class:`MemoryPlanConfig` hardware cost model (``dma_gbps`` host
bandwidth vs ``device_tflops`` recompute throughput) under the per-layer
HBM budget — see :func:`repro_torch.core.remat_policy.plan_joint_policy`.  The
resulting :class:`CompiledMemoryPlan` reports honest prices for both
eviction lanes (``dma_bytes`` covers model plans too, not just graph
schedules).

Graph plans additionally lower to an :class:`ExecutionSchedule` — a flat
list of typed ops (:class:`Compute`, :class:`SwapOut`, :class:`Prefetch`,
:class:`Free`), each carrying the tensor name, its arena offset and its EO
index — which the layer-basis executor walks directly instead of
re-interpreting the :class:`OffloadSchedule` at run time.  Each
``SwapOut``/``Prefetch`` op names one stream-ready transfer, the staging
point for lowering onto real async device streams.

MemoryPlanConfig knob table
---------------------------

======================  =====================================================
knob (default)          meaning
======================  =====================================================
``planner``             device-arena allocator: sorting | bestfit |
(``"sorting"``)         segregated | buddy | worstcase
``host_planner``        pinned-host pool allocator (same registry); the
(``"sorting"``)         host pool is packed over offloaded-copy lifetimes
``swap`` (True)         enable proactive host swapping (False = plain plan)
``min_idle_phases``     minimum EO idle window for a swap candidate (4)
``min_bytes``           minimum tensor size worth a DMA descriptor (1 MiB)
``prefetch_margin``     phases before the post-gap read to prefetch (2)
``hbm_budget_bytes``    stop choosing candidates past this reclaim (None)
``cooptimize`` (True)   iterate schedule <-> packer to a fixed point
``remat`` (None)        model path: None = follow ``cfg.remat``
``remat_budget_bytes``  per-layer activation budget for the knapsack (None)
``offload`` (None)      model path: enable the priced offload eviction lane
``dma_gbps`` (None)     host-DMA bandwidth pricing the offload lane
``device_tflops``       device throughput pricing the recompute lane (None)
``executor``            executor backend replaying the lowered schedule:
(``"sim"``)             sim (synchronous, deterministic stats) | async
                        (non-blocking copies on a CUDA copy stream into a
                        pinned host pool, fenced by events at the
                        consumer, overlap measured) | jit_blocks (not
                        ported yet: raises)
``verify``              static verification of the lowered schedule
(``"error"``)           (``repro_torch.core.verify``): "error" raises
                        ``ScheduleVerificationError`` on any violated
                        invariant, "warn" downgrades to warnings, "off"
                        skips (the report is folded into
                        ``report()["verify"]`` either way)
``deps`` (True)         static dependence analysis of the lowered schedule
                        (``repro_torch.core.verify.deps``): build the happens-
                        before DAG, plan legal compute fusion and measure
                        per-transfer slack; summary lands in
                        ``report()["deps"]`` (False skips the analysis)
``optim_offload``       optimizer state (AdamW moments) as a planned
(False)                 resource: not ported yet, True raises (ROADMAP
                        item 5)
``optim_compress``      int8 host copies of offloaded optimizer state;
(True)                  read only with ``optim_offload``
======================  =====================================================

Static verification
-------------------

``compile_plan`` runs the :mod:`repro_torch.core.verify` checker registry over
every lowered schedule before handing it to an executor: use-before-
resident, transfer races, arena aliasing (device *and* host pool — the
same sweep on both compile paths), double-free/leak, budget/alignment and
in-place-prefetch legality.  Findings are structured ``Diagnostic``
records; a failing check renders like::

    [error:use_before_resident] X:conv1: read at EO 11 while swapped out
        since EO 3 with no prefetch in between
    [error:arena_alias] op[7] X:conv1: Prefetch device offset 4096
        diverges from the packed placement (8192)

``report()["verify"]`` carries the machine-readable summary (``ok``,
``errors``, ``checks_run``, ``ops_scanned``, ``wall_time_s``); executor
backends refuse to replay a plan-backed schedule that has not passed.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.execution_order import (OrderedTensors,
                                              compute_execution_order)
from repro_torch.core.graph import LayerGraph
from repro_torch.core.offload import (OffloadSchedule, make_schedule,
                                      plan_offload)
from repro_torch.core.planner import (Plan, SwapAwarePlan, get_planner,
                                      plan_memory_swapped)
from repro_torch.core.remat_policy import (RematPlan, plan_joint_policy,
                                           transformer_intermediates)


@dataclasses.dataclass(frozen=True)
class MemoryPlanConfig:
    """Declarative memory-plan configuration — every knob in one place.

    Arena / swap knobs (layer-graph path; see :mod:`repro_torch.core.offload` for
    the knob reference):

    ``planner``          device-arena allocator: sorting | bestfit |
                         segregated | buddy | worstcase
    ``host_planner``     pinned-host pool allocator (same registry); packs
                         the offloaded copies' [swap_out, read] lifetimes
    ``swap``             enable proactive host swapping (False = plain plan)
    ``min_idle_phases``  minimum EO idle window for a swap candidate
    ``min_bytes``        minimum tensor size worth a DMA descriptor
    ``prefetch_margin``  phases before the post-gap read to start prefetch
    ``hbm_budget_bytes`` stop choosing candidates past this reclaim target
    ``cooptimize``       iterate schedule <-> packer to a fixed point,
                         dropping swaps whose vacated bytes reclaimed no
                         packed peak
    ``executor``         backend replaying the lowered ExecutionSchedule:
                         "sim" (synchronous replay, bit-for-bit stats,
                         the default) or "async" (transfers issued as
                         non-blocking copies on a CUDA copy stream into
                         one pinned host pool, dispatched ahead of need
                         and fenced by events at the consumer; achieved
                         overlap reported).  "jit_blocks" is not ported
                         yet and raises.  See
                         ``repro_torch.core.exec.backends``.
    ``verify``           static schedule verification policy: "error"
                         (default — raise ScheduleVerificationError on any
                         violated memory-safety invariant), "warn"
                         (downgrade findings to warnings), "off" (skip).
                         See ``repro_torch.core.verify``.
    ``deps``             run the static dependence analyser over the
                         lowered schedule (default True): dependence-DAG
                         edge counts, the fusion plan the jit_blocks
                         backend would execute, and per-transfer prefetch
                         slack, folded into ``report()["deps"]``.  See
                         ``repro_torch.core.verify.deps``.
    ``optim_offload``    plan optimizer state as ``O:`` slots lowered to
                         ``OptPrefetch``/``OptSwapOut`` ops: not ported
                         yet, True raises ``NotImplementedError`` (ROADMAP
                         item 5).  False (the default) keeps optimizer
                         state outside the plan.
    ``optim_compress``   int8 host copies for offloaded optimizer slots;
                         read only with ``optim_offload``

    Remat / offload knobs (model-config path — the joint planner):

    ``remat``              None = follow ``cfg.remat``; bool overrides
    ``remat_budget_bytes`` per-layer activation budget for the knapsack
                           (None = follow ``cfg.remat_budget_bytes``)
    ``offload``            enable the host-offload eviction lane so budget-
                           missing intermediates get a priced three-way
                           keep/recompute/offload decision instead of the
                           pure remat knapsack (None = follow ``cfg.offload``)
    ``dma_gbps``           host-DMA bandwidth (GB/s) pricing the offload
                           lane: one round trip costs 2*bytes/bandwidth
                           (None = follow ``cfg.dma_gbps``, else the
                           remat_policy default, 32 GB/s)
    ``device_tflops``      device throughput (TFLOP/s) pricing the recompute
                           lane (None = follow ``cfg.device_tflops``, else
                           the remat_policy default, 200 TFLOP/s)
    """

    planner: str = "sorting"
    host_planner: str = "sorting"
    swap: bool = True
    min_idle_phases: int = 4
    min_bytes: int = 1 << 20
    prefetch_margin: int = 2
    hbm_budget_bytes: Optional[int] = None
    cooptimize: bool = True
    executor: str = "sim"
    verify: str = "error"
    deps: bool = True
    optim_offload: bool = False
    optim_compress: bool = True

    remat: Optional[bool] = None
    remat_budget_bytes: Optional[int] = None
    offload: Optional[bool] = None
    dma_gbps: Optional[float] = None
    device_tflops: Optional[float] = None

    def cache_key(self) -> Tuple[Any, ...]:
        """Stable hashable key covering EVERY knob, field-order invariant.

        Compile caches (the serving plan cache, autotuner memos) must key
        on the *full* config: two tenants whose configs differ in any knob
        — planner, host_planner, budget, executor, verify, ... — may get
        materially different plans, so sharing a cache slot between them
        would silently serve one tenant the other's QoS.  Sorting by field
        name keeps the key stable under dataclass field reordering."""
        return tuple(
            (f.name, getattr(self, f.name))
            for f in sorted(dataclasses.fields(self), key=lambda f: f.name))


@dataclasses.dataclass(frozen=True)
class CooptStats:
    """What the schedule/planner co-optimisation fixed point did."""

    rounds: int                      # full drop-scan passes (>= 1)
    dropped: Tuple[str, ...]         # swaps removed as non-load-bearing
    single_pass_peak_bytes: int      # arena peak before co-optimisation
    single_pass_dma_bytes: int       # DMA traffic before co-optimisation


# ---------------------------------------------------------------------------
# ExecutionSchedule: the lowered, executor-facing IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Compute:
    """Run one layer phase (``kind`` is "F" / "CG" / "CD") at EO ``eo``."""
    eo: int
    layer: str
    kind: str


@dataclasses.dataclass(frozen=True)
class SwapOut:
    """Background D2H DMA during phase ``eo``: copy ``tensor`` from device
    arena offset ``device_offset`` to host-pool offset ``host_offset`` and
    release the device bytes when the phase completes."""
    eo: int
    tensor: str
    nbytes: int
    device_offset: int
    host_offset: int


@dataclasses.dataclass(frozen=True)
class Prefetch:
    """H2D DMA issued at the start of phase ``eo``: copy ``tensor`` back
    from host-pool offset ``host_offset`` into device arena offset
    ``device_offset``; the transfer must complete by ``read_eo`` (the
    double-buffer slot retires there)."""
    eo: int
    tensor: str
    nbytes: int
    device_offset: int
    host_offset: int
    read_eo: int


@dataclasses.dataclass(frozen=True)
class Free:
    """Release ``tensor``'s arena bytes after its last access (phase ``eo``)."""
    eo: int
    tensor: str
    nbytes: int
    device_offset: int


@dataclasses.dataclass(frozen=True)
class OptPrefetch:
    """H2D DMA issued at phase ``eo``: copy ``tensor``'s (an ``O:<layer>``
    optimizer slot) compressed host copy — ``host_nbytes`` int8+scale bytes
    at host offset ``host_offset`` — into the optimizer working region at
    ``device_offset`` and dequantize into the ``nbytes`` fp32 working
    buffer; must be consumable by the layer's CG phase ``read_eo`` (where
    the optimizer update reads the moments).

    Deliberately NOT a :class:`Prefetch` subclass: optimizer slots live in
    their own device region and host pool, so every activation-arena sweep
    (reuse edges, residency checks, transfer accounting) must stay blind to
    them — ``isinstance`` walks over the activation op types skip these by
    construction."""
    eo: int
    tensor: str
    nbytes: int
    device_offset: int
    host_offset: int
    host_nbytes: int
    read_eo: int


@dataclasses.dataclass(frozen=True)
class OptSwapOut:
    """D2H DMA during phase ``eo`` (the phase after the layer's CG update):
    copy the updated ``nbytes`` fp32 optimizer working state at
    ``device_offset`` back to the host, where it is re-quantized (with
    error feedback) into the ``host_nbytes`` compressed slot at
    ``host_offset``, then release the working-region bytes."""
    eo: int
    tensor: str
    nbytes: int
    device_offset: int
    host_offset: int
    host_nbytes: int


# Within one EO phase: prefetches start the phase (activation, then
# optimizer), compute runs, the background swap-outs drain at the end
# (optimizer state right after the update, then activations), then expired
# tensors are freed.  Only the relative order matters; the integers for
# the four original op types keep their relative order so every existing
# lowered op list sorts identically.
_OP_RANK = {Prefetch: 0, OptPrefetch: 1, Compute: 2, OptSwapOut: 3,
            SwapOut: 4, Free: 5}

ScheduleOp = Union[Compute, SwapOut, Prefetch, Free, OptPrefetch, OptSwapOut]


@dataclasses.dataclass(frozen=True)
class ExecutionSchedule:
    """The lowered memory plan: one flat op list the executor walks.

    Every scheduling decision is resolved at compile time — which tensor
    moves, when, between which arena offsets — so the executor carries no
    policy of its own: it replays the ops in order.  In-place-prefetch
    decisions emit no ops (no data moves for them); their re-residency is a
    plan-level fact.  Each ``SwapOut``/``Prefetch`` names one stream-ready
    transfer: the staging point for the async double-buffer lowering.
    """

    ops: Tuple[ScheduleOp, ...]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            key = type(op).__name__.lower()
            out[key] = out.get(key, 0) + 1
        return out

    def transfers(self) -> Tuple[ScheduleOp, ...]:
        """The DMA ops only, in issue order."""
        return tuple(op for op in self.ops
                     if isinstance(op, (SwapOut, Prefetch)))


def lower_schedule(ordered: OrderedTensors, schedule: OffloadSchedule,
                   plan: Optional[Union[Plan, SwapAwarePlan]] = None
                   ) -> ExecutionSchedule:
    """Lower (EO analysis, swap schedule, packed plan) to the flat op list.

    ``plan`` provides arena offsets; without one (hand-wired callers) the
    offsets are -1 ("unplaced").  Only ``X:`` decisions lower to transfer
    ops: ``S:`` scratch tensors never enter the layer-output store, so
    their swap is plan-level only (arena residency), nothing to move.
    In-place decisions lower to nothing — their bytes never move.
    """
    swap_aware = isinstance(plan, SwapAwarePlan)

    def device_offset(name: str, *, post: bool) -> int:
        if swap_aware:
            rs = plan.residencies.get(name)
            if rs:
                ordered_rs = sorted(rs, key=lambda r: r.min_eo)
                return ordered_rs[-1 if post else 0].offset
        elif isinstance(plan, Plan) and name in plan.placements:
            return plan.placements[name].offset
        return -1

    def host_offset(name: str) -> int:
        if swap_aware:
            hp = plan.host.placements.get(name + "@host")
            if hp is not None:
                return hp.offset
        return -1

    ops: List[ScheduleOp] = [
        Compute(eo=eo, layer=lname, kind=kind)
        for eo, lname, kind in ordered.phase_schedule()
    ]
    for d in schedule.decisions:
        if not d.vacates or d.inplace or not d.name.startswith("X:"):
            continue
        if d.name not in ordered.tensors:
            raise ValueError(
                f"offload schedule references {d.name!r}, which the "
                f"execution-order analysis does not know — schedule and "
                f"ordered tensors come from different graphs?")
        ops.append(SwapOut(eo=d.swap_out_eo, tensor=d.name, nbytes=d.nbytes,
                           device_offset=device_offset(d.name, post=False),
                           host_offset=host_offset(d.name)))
        ops.append(Prefetch(eo=d.prefetch_at_eo, tensor=d.name,
                            nbytes=d.nbytes,
                            device_offset=device_offset(d.name, post=True),
                            host_offset=host_offset(d.name),
                            read_eo=d.read_eo))
    for t in ordered.planned_tensors():
        if t.name.startswith("X:"):
            ops.append(Free(eo=t.max_eo, tensor=t.name, nbytes=t.nbytes,
                            device_offset=device_offset(t.name, post=True)))
    optim = getattr(plan, "optim", None)
    if optim is not None:
        # optimizer slots: one prefetch (compressed host copy -> fp32
        # working buffer, ready by the layer's CG update) and one swap-out
        # (updated state re-quantized back to the host slot) per slot; the
        # offsets index the optimizer plan's OWN device region / host pool,
        # not the activation arenas
        for s in optim.slots:
            dev = optim.device.placements[s.name].offset
            host = optim.host.placements[s.name + "@host"].offset
            ops.append(OptPrefetch(
                eo=s.prefetch_eo, tensor=s.name, nbytes=s.nbytes,
                device_offset=dev, host_offset=host,
                host_nbytes=s.host_nbytes, read_eo=s.read_eo))
            ops.append(OptSwapOut(
                eo=s.swapout_eo, tensor=s.name, nbytes=s.nbytes,
                device_offset=dev, host_offset=host,
                host_nbytes=s.host_nbytes))
    ops.sort(key=lambda op: (op.eo, _OP_RANK[type(op)],
                             getattr(op, "tensor", ""),
                             getattr(op, "layer", "")))
    return ExecutionSchedule(ops=tuple(ops))


@dataclasses.dataclass
class CompiledMemoryPlan:
    """Everything one compile step produced, behind one handle.

    ``source`` is "graph" (layer-basis path: ``ordered``/``schedule``/
    ``plan`` populated, ``loss_and_grads`` runnable) or "model"
    (config path: ``remat_plan`` populated, ``offload_policy`` installable
    in a jitted step).
    """

    config: MemoryPlanConfig
    source: str
    graph: Optional[LayerGraph] = None
    ordered: Optional[OrderedTensors] = None
    schedule: Optional[OffloadSchedule] = None
    plan: Optional[Union[Plan, SwapAwarePlan]] = None   # device arena
    baseline: Optional[Plan] = None                      # no-swap, same planner
    coopt: Optional[CooptStats] = None
    batch: Optional[int] = None
    # the lowered, executor-facing op list (graph path)
    lowered: Optional[ExecutionSchedule] = None

    model_config: Any = None
    remat_plan: Optional[RematPlan] = None
    batch_tokens: Optional[int] = None

    # what the last ``loss_and_grads`` execution reported (backend name,
    # transfer counts, achieved overlap for the async backend); None until
    # the compiled plan has been executed at least once
    exec_report: Optional[Dict[str, Any]] = None

    # what static verification proved (repro_torch.core.verify); None only when
    # config.verify == "off"
    verify_report: Any = None

    # what the static dependence analyser measured over the lowered
    # schedule (repro_torch.core.verify.deps): DAG edge counts, the fusion plan
    # the jit_blocks backend would execute, per-transfer prefetch slack;
    # None when config.deps is False or there is no lowered schedule
    deps_report: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- queries
    @property
    def peak_bytes(self) -> int:
        """Planned device peak: packed arena bytes (graph) or the knapsack's
        kept-intermediate bytes across layers (model)."""
        if self.plan is not None:
            return self.plan.arena_bytes
        if self.remat_plan is not None and self.model_config is not None:
            return (self.remat_plan.saved_bytes_per_layer
                    * self.model_config.n_layers)
        return 0

    @property
    def host_pool_bytes(self) -> int:
        return self.plan.host_pool_bytes \
            if isinstance(self.plan, SwapAwarePlan) else 0

    @property
    def dma_bytes(self) -> int:
        """Total device<->host traffic: the swap schedule's (graph path) or
        the offloaded intermediates' round trips across layers (model)."""
        if self.schedule is not None:
            return self.schedule.dma_bytes
        if self.remat_plan is not None and self.model_config is not None:
            return (self.remat_plan.offload_dma_bytes_per_layer
                    * self.model_config.n_layers)
        return 0

    @property
    def hbm_bytes_saved(self) -> int:
        return self.plan.hbm_bytes_saved \
            if isinstance(self.plan, SwapAwarePlan) else 0

    def swapped_names(self) -> Tuple[str, ...]:
        return self.plan.swapped_names() \
            if isinstance(self.plan, SwapAwarePlan) else ()

    @property
    def inplace_prefetch_count(self) -> int:
        """Swaps whose bytes survived in place: no host slot, no DMA."""
        return self.plan.inplace_prefetch_count \
            if isinstance(self.plan, SwapAwarePlan) else 0

    @property
    def optim_plan(self):
        """The packed optimizer-state offload plan; always None until
        optimizer offload is ported (ROADMAP item 5)."""
        return getattr(self.plan, "optim", None)

    @property
    def optim_device_bytes(self) -> int:
        """Device bytes the optimizer state needs under this plan: the
        packed working-region peak when offloaded, 0 when the plan does not
        manage optimizer state (the historical behaviour — optimizer state
        then lives outside every arena and budget)."""
        op = self.optim_plan
        return op.device_peak_bytes if op is not None else 0

    @property
    def device_utilization(self) -> Optional[float]:
        if isinstance(self.plan, SwapAwarePlan):
            return self.plan.device.utilization()
        if self.plan is not None:
            return self.plan.utilization()
        return None

    @property
    def host_utilization(self) -> Optional[float]:
        return self.plan.host.utilization() \
            if isinstance(self.plan, SwapAwarePlan) else None

    @property
    def offload_policy(self):
        """The checkpoint policy realising this plan's keep/offload
        decisions, or None when no policy applies.

        Only model-config plans have one, and the port has not realised it
        yet: :meth:`RematPlan.policy` raises ``NotImplementedError``
        (ROADMAP item 8).  Graph plans execute their swap schedule through
        the layer-basis executor (``loss_and_grads``) instead."""
        if self.remat_plan is not None:
            return self.remat_plan.policy()
        return None

    # ------------------------------------------------------------ executor
    def init_params(self, generator, device=None):
        """He-init parameters for the compiled graph (graph path only),
        drawn from the ``torch.Generator`` ``generator`` and placed on
        ``device`` (the CUDA card when None)."""
        self._require_graph("init_params")
        from repro_torch.core.exec.layers import init_params
        return init_params(self.graph, generator, device=device)

    def loss_and_grads(self, params, x, label, *, executor=None, mask=None,
                       engine=None):
        """One layer-basis training iteration under this plan.

        Replays the lowered op list on the configured executor backend
        (``config.executor``; the ``executor=`` argument overrides per
        call — a registry name or an ``ExecutorBackend`` instance).  An
        empty schedule degrades to the plain planned walk; the HBM
        high-water mark is asserted against the packed residency peak on
        every backend.  ``mask`` is an optional (batch,) sample mask for
        pad-to-bucket batches: masked rows contribute an exactly-zero loss
        derivative, so grads match the unpadded batch (the serving path's
        bucket padding).  The backend's post-run summary (transfer counts,
        and for ``"async"`` the achieved overlap vs the planned
        ``peak_inflight_prefetch``) lands in ``self.exec_report`` and is
        folded into :meth:`report`.  Returns ``(loss, grads,
        SwapExecStats)``.

        ``engine`` optionally injects a :class:`TransferEngine` into the
        replay backends (``"sim"``/``"async"``) — e.g. a bus-paced engine
        for emulated-hardware benchmarks; the jit-fused backend manages
        its own engine and rejects the override.
        """
        self._require_graph("loss_and_grads")
        from repro_torch.core.exec.backends import get_backend
        backend = get_backend(
            executor if executor is not None else self.config.executor)
        extra = {} if engine is None else {"engine": engine}
        out = backend.run(
            self.graph, params, x, label,
            schedule=self.schedule,
            ordered=self.ordered,
            plan=self.plan if isinstance(self.plan, SwapAwarePlan) else None,
            lowered=self.lowered,
            mask=mask,
            **extra,
        )
        self.exec_report = backend.report()
        return out

    def _require_graph(self, what: str) -> None:
        if self.source != "graph" or self.graph is None:
            raise TypeError(
                f"{what} needs a plan compiled from a LayerGraph; this plan "
                f"was compiled from a model config")

    # ------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        """Machine-readable summary (the BENCH_swap.json row shape)."""
        out: Dict[str, Any] = {
            "source": self.source,
            "planner": self.config.planner,
            # the backend that actually executed (a per-call executor=
            # override wins over the configured knob); the config knob
            # until the plan has run
            "executor": ((self.exec_report or {}).get("backend")
                         or self.config.executor),
            "peak_bytes": self.peak_bytes,
            "host_pool_bytes": self.host_pool_bytes,
            "dma_bytes": self.dma_bytes,
            "hbm_bytes_saved": self.hbm_bytes_saved,
            "n_swaps": len(self.swapped_names()),
        }
        if self.source == "graph":
            out["graph"] = self.graph.name
            out["batch"] = self.batch
            out["baseline_peak_bytes"] = self.baseline.arena_bytes
            out["host_planner"] = self.config.host_planner
            out["inplace_prefetch_count"] = self.inplace_prefetch_count
            if self.device_utilization is not None:
                out["device_utilization"] = self.device_utilization
            if self.host_utilization is not None:
                out["host_utilization"] = self.host_utilization
            if self.lowered is not None:
                out["schedule_ops"] = self.lowered.counts()
            if self.optim_plan is not None:
                out["optim"] = self.optim_plan.summary()
            if self.exec_report is not None:
                # what the last execution measured, incl. the async
                # backend's achieved overlap vs peak_inflight_prefetch
                out["exec"] = dict(self.exec_report)
        if self.verify_report is not None:
            out["verify"] = self.verify_report.summary()
        if self.deps_report is not None:
            out["deps"] = dict(self.deps_report)
        if self.coopt is not None:
            out["coopt_rounds"] = self.coopt.rounds
            out["coopt_dropped"] = list(self.coopt.dropped)
            out["single_pass_peak_bytes"] = self.coopt.single_pass_peak_bytes
            out["single_pass_dma_bytes"] = self.coopt.single_pass_dma_bytes
        if self.remat_plan is not None:
            rp = self.remat_plan
            out["remat_saved"] = list(rp.saved)
            out["remat_dropped"] = list(rp.dropped)
            out["remat_offloaded"] = list(rp.offloaded)
            out["remat_decisions"] = rp.decisions()
            out["saved_bytes_per_layer"] = rp.saved_bytes_per_layer
            out["recompute_flops_per_layer"] = rp.recompute_flops_per_layer
            out["offload_dma_bytes_per_layer"] = rp.offload_dma_bytes_per_layer
            out["est_step_time_s_per_layer"] = rp.est_step_time_s_per_layer
        return out


# ---------------------------------------------------------------------------
# Schedule/planner co-optimisation: iterate to a fixed point
# ---------------------------------------------------------------------------

def _cooptimize(ordered: OrderedTensors, plan: SwapAwarePlan, planner: str,
                host_planner: str
                ) -> Tuple[SwapAwarePlan, int, List[str]]:
    """Drop swaps whose vacated bytes reclaimed no packed peak; re-plan.

    A swap is non-load-bearing when re-packing *without* it yields the same
    (or a lower) arena peak: its two DMA transfers buy nothing.  In-place
    decisions are never scan candidates — they already move no data, so
    dropping them saves nothing and only removes planner freedom.  An
    accepted drop continues the scan from the *next* decision (restarting
    from the first would cost O(n^2) full re-packs per fixed point); one
    more full pass runs after any pass that dropped something, so the loop
    only stops when a complete scan accepts nothing.  The decision set
    strictly shrinks and the peak is monotone non-increasing — never above
    the single-pass input plan.  At the fixed point every remaining
    data-moving swap is load-bearing: removing any one of them would raise
    the packed peak.
    """
    rounds = 0
    dropped: List[str] = []
    improved = True
    while improved:
        rounds += 1
        improved = False
        for name in [d.name for d in plan.schedule.decisions
                     if not d.inplace]:
            # an earlier drop in this pass re-packed the arena and may have
            # re-flagged this decision as in-place — re-check the CURRENT
            # plan, not the pass-start snapshot, before trialing a drop
            cur = next((d for d in plan.schedule.decisions
                        if d.name == name), None)
            if cur is None or cur.inplace:
                continue
            rest = tuple(o for o in plan.schedule.decisions
                         if o.name != name)
            trial_plan = plan_memory_swapped(ordered, make_schedule(rest),
                                             planner=planner,
                                             host_planner=host_planner)
            if trial_plan.arena_bytes <= plan.arena_bytes:
                plan = trial_plan
                dropped.append(name)
                improved = True
    return plan, rounds, dropped


# ---------------------------------------------------------------------------
# Static verification hook
# ---------------------------------------------------------------------------

_VERIFY_MODES = ("error", "warn", "off")


def _apply_verify(cp: CompiledMemoryPlan) -> CompiledMemoryPlan:
    """Run the static verifier over a freshly compiled plan.

    Policy comes from ``config.verify``: ``"error"`` raises
    :class:`repro_torch.core.verify.ScheduleVerificationError` on any error
    diagnostic, ``"warn"`` downgrades them to :class:`UserWarning`,
    ``"off"`` skips entirely.  A clean run marks the lowered schedule as
    verified so executor backends admit it without re-checking.

    The static dependence analyser (``config.deps``) rides the same hook:
    its summary — DAG edge counts, the fusion plan the jit_blocks backend
    would execute, per-transfer prefetch slack — lands in
    ``cp.deps_report`` (and ``report()["deps"]``) regardless of the
    verify policy."""
    if cp.config.deps and cp.lowered is not None:
        from repro_torch.core.verify import deps_summary
        cp.deps_report = deps_summary(cp.lowered, cp.ordered, cp.plan)
    if cp.config.verify == "off":
        return cp
    from repro_torch.core import verify as _verify
    report = _verify.verify_plan(cp)
    cp.verify_report = report
    if report.ok:
        if cp.lowered is not None:
            _verify.mark_verified(cp.lowered)
    elif cp.config.verify == "error":
        report.raise_if_errors()
    else:
        for d in report.errors():
            warnings.warn(f"schedule verification: {d.render()}",
                          UserWarning, stacklevel=4)
    return cp


def _check_verify_mode(config: MemoryPlanConfig) -> None:
    if config.verify not in _VERIFY_MODES:
        raise ValueError(
            f"unknown verify mode {config.verify!r}: choose from "
            f"{', '.join(_VERIFY_MODES)}")


# ---------------------------------------------------------------------------
# compile_plan: the single entry point
# ---------------------------------------------------------------------------

def compile_plan(graph_or_model, config: Optional[MemoryPlanConfig] = None,
                 *, batch: int = 32,
                 batch_tokens: Optional[int] = None) -> CompiledMemoryPlan:
    """Compile a memory plan from a declarative config — the one entry point.

    ``graph_or_model`` is either a :class:`LayerGraph` (``batch`` sizes the
    EO analysis) or a transformer-shaped ``ModelConfig`` (``batch_tokens``
    sizes the remat knapsack and is required).  ``config`` defaults to
    :class:`MemoryPlanConfig()`.
    """
    config = config or MemoryPlanConfig()
    if isinstance(graph_or_model, LayerGraph):
        return _compile_graph_plan(graph_or_model, config, batch)
    return _compile_model_plan(graph_or_model, config, batch_tokens)


def _compile_graph_plan(graph: LayerGraph, config: MemoryPlanConfig,
                        batch: int) -> CompiledMemoryPlan:
    # fail fast on planner- and executor-name typos, before any analysis;
    # the executor name is checked against the port's registry
    from repro_torch.core.exec.backends import get_backend
    get_planner(config.planner)
    get_planner(config.host_planner)
    get_backend(config.executor)
    _check_verify_mode(config)
    if config.optim_offload:
        raise NotImplementedError(
            "optim_offload=True is not ported yet: the optimizer-state "
            "offload runtime is ROADMAP item 5")

    ordered = compute_execution_order(graph, batch)
    baseline = get_planner(config.planner).plan(ordered)


    if not config.swap:
        empty = make_schedule(())
        return _apply_verify(CompiledMemoryPlan(
            config=config, source="graph", graph=graph, ordered=ordered,
            schedule=empty, plan=baseline, baseline=baseline, batch=batch,
            lowered=lower_schedule(ordered, empty, baseline)))

    schedule = plan_offload(
        ordered,
        min_idle_phases=config.min_idle_phases,
        min_bytes=config.min_bytes,
        prefetch_margin=config.prefetch_margin,
        hbm_budget_bytes=config.hbm_budget_bytes,
    )
    plan = plan_memory_swapped(ordered, schedule, planner=config.planner,
                               host_planner=config.host_planner)
    # the swap-aware placement pass may have lowered some swaps to in-place
    # prefetches: the plan's rebuilt schedule is the authoritative one
    single_peak, single_dma = plan.arena_bytes, plan.schedule.dma_bytes

    coopt = None
    if config.cooptimize:
        plan, rounds, dropped = _cooptimize(
            ordered, plan, config.planner, config.host_planner)
        coopt = CooptStats(rounds=rounds, dropped=tuple(dropped),
                           single_pass_peak_bytes=single_peak,
                           single_pass_dma_bytes=single_dma)

    return _apply_verify(CompiledMemoryPlan(
        config=config, source="graph", graph=graph, ordered=ordered,
        schedule=plan.schedule, plan=plan, baseline=baseline, coopt=coopt,
        batch=batch, lowered=lower_schedule(ordered, plan.schedule, plan)))


def _compile_model_plan(cfg, config: MemoryPlanConfig,
                        batch_tokens: Optional[int]) -> CompiledMemoryPlan:
    # the executor knob travels with the config even on the model path
    # (model plans install a checkpoint policy instead of running the
    # layer-basis executor) — still fail fast on typos
    from repro_torch.core.exec.backends import get_backend
    get_backend(config.executor)
    _check_verify_mode(config)
    if batch_tokens is None:
        raise TypeError("compile_plan(model_config) requires batch_tokens=")
    remat_on = config.remat if config.remat is not None \
        else bool(getattr(cfg, "remat", False))
    if not remat_on:
        return _apply_verify(CompiledMemoryPlan(
            config=config, source="model", model_config=cfg,
            batch_tokens=batch_tokens))
    budget = config.remat_budget_bytes if config.remat_budget_bytes is not None \
        else getattr(cfg, "remat_budget_bytes", None)

    # the ``offload`` knob / ``cfg.offload`` enables the priced joint planner
    offload_on = config.offload if config.offload is not None \
        else bool(getattr(cfg, "offload", False))
    dma_gbps = config.dma_gbps if config.dma_gbps is not None \
        else getattr(cfg, "dma_gbps", None)
    device_tflops = config.device_tflops if config.device_tflops is not None \
        else getattr(cfg, "device_tflops", None)

    inter = transformer_intermediates(
        batch_tokens=batch_tokens, d_model=cfg.d_model,
        d_ff=cfg.moe_d_ff if getattr(cfg, "is_moe", False) else cfg.d_ff,
        n_q_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim,
        moe_experts_per_token=getattr(cfg, "top_k", 0),
    )
    if offload_on and budget is None:
        # keeping everything is cost-optimal without budget pressure, so a
        # budget-less "offload lane on" config offloads nothing — say so
        # instead of silently no-opping (the failure mode the old
        # offload-everything quirk existed to prevent)
        warnings.warn(
            "offload lane enabled but no per-layer HBM budget is set "
            "(remat_budget_bytes is None): keeping every intermediate is "
            "cost-optimal, so nothing will be offloaded; set a budget to "
            "create eviction pressure",
            UserWarning, stacklevel=3)
    remat_plan = plan_joint_policy(
        inter, budget, offload=offload_on,
        dma_gbps=dma_gbps,
        device_tflops=device_tflops)
    return _apply_verify(CompiledMemoryPlan(
        config=config, source="model", model_config=cfg,
        remat_plan=remat_plan, batch_tokens=batch_tokens))


# ---------------------------------------------------------------------------
# Budget-share compile: fit a plan inside one tenant's arena slice
# ---------------------------------------------------------------------------

class ArenaBudgetError(RuntimeError):
    """No plan configuration packed the graph inside the arena budget.

    Raised by :func:`compile_plan_under_budget` when even the most
    aggressive swap escalation leaves the packed device-arena peak above
    the caller's byte budget.  Carries the best (lowest-peak) attempt so
    admission controllers can report how far over budget the tenant is.
    """

    def __init__(self, msg: str, *, best_peak_bytes: int,
                 arena_budget_bytes: int):
        super().__init__(msg)
        self.best_peak_bytes = best_peak_bytes
        self.arena_budget_bytes = arena_budget_bytes


# Escalation ladder for compile_plan_under_budget: after the caller's own
# config, each rung swaps more aggressively (shorter idle windows, smaller
# DMA-worthy tensors, no reclaim cap).  Deterministic, so two tenants with
# the same (graph, batch, config, budget) always converge on the same plan
# — the property the serving compile cache relies on.
_BUDGET_ESCALATION: Tuple[Dict[str, Any], ...] = (
    {"min_idle_phases": 3, "min_bytes": 1 << 14, "hbm_budget_bytes": None},
    {"min_idle_phases": 2, "min_bytes": 1 << 12, "hbm_budget_bytes": None},
    {"min_idle_phases": 2, "min_bytes": 1 << 9, "prefetch_margin": 1,
     "hbm_budget_bytes": None, "planner": "bestfit"},
)


def compile_plan_under_budget(graph: LayerGraph,
                              config: Optional[MemoryPlanConfig] = None,
                              *, batch: int,
                              arena_budget_bytes: int) -> CompiledMemoryPlan:
    """Compile a graph plan whose packed device-arena peak fits a budget.

    The QoS lever of multi-tenant serving: N concurrent sessions split one
    device arena, so each session's plan must pack inside its share.  The
    caller's ``config`` is tried first; if its peak exceeds
    ``arena_budget_bytes`` the swap knobs escalate down the deterministic
    ladder (shorter idle windows, smaller ``min_bytes``, uncapped reclaim)
    until the plan fits.  Raises :class:`ArenaBudgetError` when even the
    most aggressive rung cannot fit — the admission controller's signal to
    reject the session instead of overcommitting the arena.
    """
    config = config or MemoryPlanConfig()
    best: Optional[CompiledMemoryPlan] = None
    tried: List[Tuple[str, int]] = []
    for overrides in ({},) + _BUDGET_ESCALATION:
        rung = dataclasses.replace(config, swap=True, **overrides) \
            if overrides else config
        cp = compile_plan(graph, rung, batch=batch)
        tried.append((f"idle={rung.min_idle_phases}/"
                      f"min_bytes={rung.min_bytes}", cp.peak_bytes))
        if cp.peak_bytes <= arena_budget_bytes:
            return cp
        if best is None or cp.peak_bytes < best.peak_bytes:
            best = cp
    attempts = ", ".join(f"{k}: peak={v}" for k, v in tried)
    raise ArenaBudgetError(
        f"{graph.name} batch={batch} cannot pack inside "
        f"{arena_budget_bytes} arena bytes ({attempts})",
        best_peak_bytes=best.peak_bytes,
        arena_budget_bytes=arena_budget_bytes)
