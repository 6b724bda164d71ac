"""Static dependence analysis + fusion-legality prover over the lowered IR.

The checker passes prove a *given*
:class:`~repro_torch.core.plan.ExecutionSchedule` memory-safe; this module
proves that a *reordered or fused* schedule is equivalent to the verified
one — the analysis that separates planned-memory
prototypes from deployable runtimes (On-device Training systems survey).

Three provers over the happens-before dependence DAG extracted from per-op
read/write sets (tensors *and* arena byte ranges):

* :func:`schedules_equivalent` — a permuted/fused candidate op stream
  preserves every dependence edge of the verifier-signed original
  (check ids ``dep_edge`` / ``dep_transfer_fence`` / ``dep_stream``);
  the admission gate of the ``jit_blocks`` executor backend.
* :func:`plan_fusion` — the maximal runs of ``Compute`` ops whose fusion
  crosses no transfer fence, no ``Free``-reuse hazard and no
  in-place-prefetch window, with ``Free`` ops absorbed (deferred to the
  block end) under the packed residency peak.  :func:`verify_fusion`
  re-proves a :class:`FusionPlan` independently (check ids
  ``fusion_fence`` / ``fusion_hazard`` / ``fusion_peak``) and
  :func:`replay_stream` materialises the fused op order.
* :func:`transfer_slack` — per-transfer static slack from critical-path
  analysis: how many compute phases each DMA has to hide behind.  The
  static denominator for the async backend's achieved-overlap number.

The dependence edge families (every edge is oriented by the canonical
lowering sort key, so a clean lowered schedule is always a linear
extension of its own DAG):

* ``data`` — the compute spine (computes never reorder against each
  other: the interpreter threads derivs/ctx state through every phase),
  plus each ``SwapOut``/``Free`` after the ``Compute`` of its phase;
* ``fence`` — ``SwapOut(t)`` before ``Prefetch(t)``, and ``Prefetch(t)``
  before the consuming ``Compute`` at its ``read_eo``;
* ``reuse`` — arena-byte WAR/WAW edges: a device-range evictor
  (``SwapOut``/``Free``) before any later writer of overlapping bytes
  (``Prefetch`` target or producing ``F`` compute), and a host-slot
  reader (``Prefetch``) before a later ``SwapOut`` reusing its slot.

:func:`check_deps` wraps the self-equivalence proof as a registry pass
(``CHECKS["deps"]``); :func:`deps_summary` folds edge counts, the fusion
plan and the slack table into ``CompiledMemoryPlan.report()["deps"]``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.planner import SwapAwarePlan, _align
from repro_torch.core.verify.checks import (SEV_ERROR, CheckContext, Diagnostic,
                                            VerifyReport)


def _ops_of(schedule_or_ops) -> Tuple[Any, ...]:
    """Accept an ExecutionSchedule or a raw op sequence."""
    return tuple(getattr(schedule_or_ops, "ops", schedule_or_ops))


def _canon_key(op) -> Tuple[int, int, str, str]:
    """The lowering sort key — the canonical happens-before position of an
    op, independent of where a (possibly corrupted) list placed it."""
    from repro_torch.core.plan import _OP_RANK
    return (op.eo, _OP_RANK[type(op)], getattr(op, "tensor", ""),
            getattr(op, "layer", ""))


def _describe(op) -> str:
    who = getattr(op, "tensor", None) or getattr(op, "layer", "")
    return f"{type(op).__name__}(eo={op.eo}, {who})"


@dataclasses.dataclass(frozen=True)
class DepEdge:
    """One happens-before edge: op ``src`` must execute before ``dst``.

    ``src``/``dst`` index :attr:`DependenceGraph.ops`; ``kind`` is
    ``"data"`` | ``"fence"`` | ``"reuse"``; ``check`` the id a violation
    is reported under (``dep_edge`` or ``dep_transfer_fence``)."""

    src: int
    dst: int
    kind: str
    check: str
    tensor: Optional[str] = None
    why: str = ""


@dataclasses.dataclass(frozen=True)
class DependenceGraph:
    """The happens-before DAG of one lowered schedule."""

    ops: Tuple[Any, ...]
    edges: Tuple[DepEdge, ...]

    def edge_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {"data": 0, "fence": 0, "reuse": 0}
        for e in self.edges:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def check_order(self, candidate_ops: Sequence[Any]) -> List[Diagnostic]:
        """Is ``candidate_ops`` a linear extension of this DAG?

        Two proofs: the candidate replays exactly the original op multiset
        (``dep_stream`` — no op dropped, duplicated or invented), and every
        dependence edge's endpoints appear in order (``dep_edge`` /
        ``dep_transfer_fence``)."""
        cand = _ops_of(candidate_ops)
        diags: List[Diagnostic] = []
        want, got = Counter(self.ops), Counter(cand)
        if want != got:
            missing = want - got
            extra = got - want
            for op, n in sorted(missing.items(), key=lambda e: _canon_key(e[0])):
                diags.append(Diagnostic(
                    SEV_ERROR, "dep_stream",
                    f"candidate stream dropped {_describe(op)} x{n}",
                    tensor=getattr(op, "tensor", None)))
            for op, n in sorted(extra.items(), key=lambda e: _canon_key(e[0])):
                diags.append(Diagnostic(
                    SEV_ERROR, "dep_stream",
                    f"candidate stream invented {_describe(op)} x{n}",
                    tensor=getattr(op, "tensor", None)))
        pos: Dict[Any, int] = {}
        for i, op in enumerate(cand):
            pos.setdefault(op, i)
        for e in self.edges:
            src, dst = self.ops[e.src], self.ops[e.dst]
            ps, pd = pos.get(src), pos.get(dst)
            if ps is None or pd is None:
                continue   # already a dep_stream finding
            if ps >= pd:
                diags.append(Diagnostic(
                    SEV_ERROR, e.check,
                    f"{e.kind} edge violated: {_describe(src)} must precede "
                    f"{_describe(dst)} ({e.why}), found at positions "
                    f"{ps} >= {pd}", op_index=pd, tensor=e.tensor))
        return diags


def build_dependence_graph(schedule_or_ops, ordered=None,
                           plan=None) -> DependenceGraph:
    """Extract per-op read/write sets and build the happens-before DAG.

    ``ordered``/``plan`` sharpen the arena-reuse family with the packed
    placements (producing ``F`` computes get their device byte range);
    without them only the ranges the transfer/free ops themselves carry
    are used.  Every edge is oriented by the canonical lowering key, so
    the DAG is acyclic by construction and a canonically lowered op list
    is always one of its linear extensions.

    Optimizer-slot ops (``OptPrefetch``/``OptSwapOut``) get their own edge
    families — prefetch before the consuming CG compute, the CG compute
    before the swap-out, prefetch before swap-out (WAR on the working
    buffer), and working-region byte reuse between slots — but never mix
    with the activation-arena reuse scans: their offsets index a separate
    device region, so byte comparisons across the two families would be
    meaningless."""
    from repro_torch.core.plan import (Compute, Free, OptPrefetch, OptSwapOut,
                                       Prefetch, SwapOut)
    ops = _ops_of(schedule_or_ops)
    edges: List[DepEdge] = []
    key = [_canon_key(op) for op in ops]

    computes = sorted((i for i, op in enumerate(ops)
                       if isinstance(op, Compute)), key=lambda i: key[i])
    compute_at_eo: Dict[int, int] = {ops[i].eo: i for i in computes}

    # -- data: the compute spine (the interpreter threads state through
    # every phase, so computes are totally ordered among themselves)
    for a, b in zip(computes, computes[1:]):
        edges.append(DepEdge(
            a, b, "data", "dep_edge", tensor=None,
            why=f"phase {ops[a].eo} state feeds phase {ops[b].eo}"))

    def phase_compute(eo: int) -> Optional[int]:
        ci = compute_at_eo.get(eo)
        if ci is not None:
            return ci
        earlier = [i for i in computes if ops[i].eo <= eo]
        return earlier[-1] if earlier else None

    # -- data: an evictor reads/releases its tensor only after the compute
    # of its scheduled phase (the swap drains at the end of the phase, the
    # free runs after the last access)
    for i, op in enumerate(ops):
        if isinstance(op, (SwapOut, Free, OptSwapOut)):
            ci = phase_compute(op.eo)
            if ci is not None:
                edges.append(DepEdge(
                    ci, i, "data", "dep_edge", tensor=op.tensor,
                    why=f"{op.tensor} still accessed at EO {ops[ci].eo}"))

    # -- fence: SwapOut(t) -> Prefetch(t) (the prefetch re-reads the host
    # copy the swap-out wrote), Prefetch(t) -> consuming Compute(read_eo)
    out_of: Dict[str, int] = {}
    for i, op in enumerate(ops):
        if isinstance(op, SwapOut):
            out_of[op.tensor] = i
        elif isinstance(op, Prefetch):
            oi = out_of.get(op.tensor)
            if oi is not None:
                edges.append(DepEdge(
                    oi, i, "fence", "dep_transfer_fence", tensor=op.tensor,
                    why="prefetch re-reads the host copy its swap-out "
                        "wrote"))
            ri = compute_at_eo.get(op.read_eo)
            if ri is not None:
                edges.append(DepEdge(
                    i, ri, "fence", "dep_transfer_fence", tensor=op.tensor,
                    why=f"consumer at EO {op.read_eo} fences this "
                        f"prefetch"))

    # -- fence/data: optimizer slot ops.  Within one step the prefetch
    # comes FIRST (dequantized state feeds the CG update, then the updated
    # state drains): OptPrefetch(t) -> consuming CG compute, CG compute ->
    # OptSwapOut(t), and OptPrefetch(t) -> OptSwapOut(t) (WAR on the
    # working buffer and on the host slot both ops address).
    opt_in_of: Dict[str, int] = {}
    for i, op in enumerate(ops):
        if isinstance(op, OptPrefetch):
            opt_in_of[op.tensor] = i
            ri = compute_at_eo.get(op.read_eo)
            if ri is not None:
                edges.append(DepEdge(
                    i, ri, "fence", "dep_transfer_fence", tensor=op.tensor,
                    why=f"the optimizer update at EO {op.read_eo} reads "
                        f"this slot's dequantized state"))
        elif isinstance(op, OptSwapOut):
            pi = opt_in_of.get(op.tensor)
            if pi is not None:
                edges.append(DepEdge(
                    pi, i, "fence", "dep_transfer_fence", tensor=op.tensor,
                    why="swap-out overwrites the working buffer and host "
                        "slot its prefetch read"))

    # -- reuse: optimizer working-region bytes between slots (their own
    # address space — never compared against activation-arena offsets)
    def opt_range(op) -> Optional[Tuple[int, int]]:
        if op.device_offset < 0:
            return None
        return (op.device_offset, op.device_offset + _align(op.nbytes))

    opt_evictors = [(i, op.tensor, opt_range(op))
                    for i, op in enumerate(ops)
                    if isinstance(op, OptSwapOut) and opt_range(op)]
    opt_writers = [(i, op.tensor, opt_range(op))
                   for i, op in enumerate(ops)
                   if isinstance(op, OptPrefetch) and opt_range(op)]
    for ei, etensor, (elo, ehi) in opt_evictors:
        for wi, wtensor, (wlo, whi) in opt_writers:
            if wtensor == etensor or key[wi] <= key[ei]:
                continue
            if not (whi <= elo or ehi <= wlo):
                edges.append(DepEdge(
                    ei, wi, "reuse", "dep_edge", tensor=wtensor,
                    why=f"optimizer working bytes "
                        f"[{max(elo, wlo)},{min(ehi, whi)}) of {etensor} "
                        f"are reused by {wtensor}"))

    # -- reuse: arena byte-range WAR/WAW.  Device: an evictor's vacated
    # range must precede any later writer of overlapping bytes; host: a
    # prefetch retires its host slot before a later swap-out reuses it.
    def dev_range(op) -> Optional[Tuple[int, int]]:
        off = getattr(op, "device_offset", -1)
        if off is None or off < 0:
            return None
        return (off, off + _align(op.nbytes))

    def host_range(op) -> Optional[Tuple[int, int]]:
        off = getattr(op, "host_offset", -1)
        if off is None or off < 0:
            return None
        return (off, off + _align(op.nbytes))

    # producing-F-compute write ranges come from the packed pre-placement
    producer_writes: List[Tuple[int, str, Tuple[int, int]]] = []
    if ordered is not None and plan is not None:
        ctx = CheckContext.build(ordered, None, plan, None)
        for name, t in ctx.activations.items():
            eo = ctx.producer_eo(name)
            ci = compute_at_eo.get(eo)
            off = ctx.planned_device_offset(name, post=False)
            if ci is not None and off >= 0:
                producer_writes.append(
                    (ci, name, (off, off + ctx.aligned_nbytes(name))))

    evictors = [(i, op.tensor, dev_range(op)) for i, op in enumerate(ops)
                if isinstance(op, (SwapOut, Free)) and dev_range(op)]
    dev_writers = [(i, op.tensor, dev_range(op)) for i, op in enumerate(ops)
                   if isinstance(op, Prefetch) and dev_range(op)]
    dev_writers += producer_writes
    for ei, etensor, (elo, ehi) in evictors:
        for wi, wtensor, (wlo, whi) in dev_writers:
            if wtensor == etensor or key[wi] <= key[ei]:
                continue
            if not (whi <= elo or ehi <= wlo):
                edges.append(DepEdge(
                    ei, wi, "reuse", "dep_edge", tensor=wtensor,
                    why=f"device bytes [{max(elo, wlo)},{min(ehi, whi)}) "
                        f"of {etensor} are reused by {wtensor}"))

    host_readers = [(i, op.tensor, host_range(op))
                    for i, op in enumerate(ops)
                    if isinstance(op, Prefetch) and host_range(op)]
    host_writers = [(i, op.tensor, host_range(op))
                    for i, op in enumerate(ops)
                    if isinstance(op, SwapOut) and host_range(op)]
    for ri, rtensor, (rlo, rhi) in host_readers:
        for wi, wtensor, (wlo, whi) in host_writers:
            if wtensor == rtensor or key[wi] <= key[ri]:
                continue
            if not (whi <= rlo or rhi <= wlo):
                edges.append(DepEdge(
                    ri, wi, "reuse", "dep_edge", tensor=wtensor,
                    why=f"host slot [{max(rlo, wlo)},{min(rhi, whi)}) of "
                        f"{rtensor} is reused by {wtensor}"))

    return DependenceGraph(ops=ops, edges=tuple(edges))


def schedules_equivalent(original, candidate, *, ordered=None,
                         plan=None) -> VerifyReport:
    """Prove ``candidate`` preserves every dependence edge of ``original``.

    ``original`` is the verifier-signed op stream (an
    :class:`~repro_torch.core.plan.ExecutionSchedule` or raw op tuple);
    ``candidate`` the permuted/fused replay to admit.  Returns a
    :class:`VerifyReport` (``ok`` means equivalent); raising is the
    caller's policy."""
    t0 = time.perf_counter()
    graph = build_dependence_graph(original, ordered, plan)
    diags = graph.check_order(candidate)
    dt = time.perf_counter() - t0
    return VerifyReport(
        diagnostics=tuple(diags), checks_run=("deps",),
        ops_scanned=len(graph.ops) + len(_ops_of(candidate)),
        placements_scanned=0, wall_time_s=dt,
        check_seconds={"deps": dt})


def check_deps(ctx: CheckContext) -> List[Diagnostic]:
    """Registry pass: the op list must be a linear extension of its own
    happens-before DAG.  A canonically lowered schedule always is (every
    edge is oriented by the lowering sort key); a permuted one that broke
    an edge is named op-by-op."""
    if not ctx.ops:
        return []
    graph = build_dependence_graph(ctx.ops, ctx.ordered, ctx.plan)
    return graph.check_order(ctx.ops)


# ---------------------------------------------------------------------------
# Static slack: the critical-path denominator for achieved overlap
# ---------------------------------------------------------------------------

def transfer_slack(schedule_or_ops) -> Dict[str, Any]:
    """Per-transfer static slack from critical-path analysis.

    A prefetch issued at EO ``e`` must complete by ``read_eo``: the
    computes dispatched in ``[e, read_eo)`` are the window the DMA can
    hide behind — ``window_computes`` is its length on the compute
    critical path and ``slack_phases`` the raw phase distance.  A
    swap-out's slack runs until its own prefetch re-reads the host copy.
    The minimum over all transfers bounds the overlap any backend can
    achieve without stalling a fence."""
    from repro_torch.core.plan import Compute, Prefetch, SwapOut
    ops = _ops_of(schedule_or_ops)
    compute_eos = sorted(op.eo for op in ops if isinstance(op, Compute))

    def computes_in(lo: int, hi: int) -> int:
        return sum(1 for eo in compute_eos if lo <= eo < hi)

    per: Dict[str, Dict[str, int]] = {}
    out_eo: Dict[str, int] = {}
    for op in ops:
        if isinstance(op, SwapOut):
            out_eo[op.tensor] = op.eo
        elif isinstance(op, Prefetch):
            entry = {
                "prefetch_eo": op.eo,
                "read_eo": op.read_eo,
                "slack_phases": op.read_eo - op.eo,
                "window_computes": computes_in(op.eo, op.read_eo),
            }
            if op.tensor in out_eo:
                entry["swap_out_eo"] = out_eo[op.tensor]
                entry["swap_window_phases"] = op.eo - out_eo[op.tensor]
            per[op.tensor] = entry
    slacks = [e["slack_phases"] for e in per.values()]
    return {
        "transfers": per,
        "min_prefetch_slack_phases": min(slacks) if slacks else None,
        "mean_prefetch_slack_phases": (statistics.fmean(slacks)
                                       if slacks else None),
    }


# ---------------------------------------------------------------------------
# Fusion planning: maximal legal Compute runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedBlock:
    """One proven-fusable run: its ``Compute`` members dispatch as a single
    call, its absorbed ``Free`` ops are deferred to the block end."""

    index: int
    op_indices: Tuple[int, ...]        # indices into the original op list
    compute_indices: Tuple[int, ...]
    free_indices: Tuple[int, ...]

    def span(self) -> Tuple[int, int]:
        return (min(self.op_indices), max(self.op_indices))


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """plan_fusion's result: which ops fuse, and why the rest do not."""

    blocks: Tuple[FusedBlock, ...]
    n_ops: int
    n_computes: int
    fence_splits: int          # runs ended by a SwapOut/Prefetch
    hazard_splits: int         # runs ended by a Free-reuse hazard
    inplace_splits: int        # runs ended at an in-place re-admission
    peak_splits: int           # runs ended by the residency-peak guard

    def fused_computes(self) -> int:
        return sum(len(b.compute_indices) for b in self.blocks)

    def dispatch_calls(self) -> int:
        """Python-level dispatches replaying under this plan: one per
        block plus one per op outside any block."""
        covered = sum(len(b.op_indices) for b in self.blocks)
        return self.n_ops - covered + len(self.blocks)

    def largest_block(self) -> int:
        return max((len(b.compute_indices) for b in self.blocks), default=0)

    def summary(self) -> Dict[str, Any]:
        return {
            "n_blocks": len(self.blocks),
            "fused_computes": self.fused_computes(),
            "n_computes": self.n_computes,
            "n_ops": self.n_ops,
            "largest_block": self.largest_block(),
            "dispatch_calls": self.dispatch_calls(),
            "splits": {
                "fence": self.fence_splits,
                "hazard": self.hazard_splits,
                "inplace": self.inplace_splits,
                "peak": self.peak_splits,
            },
        }


def _fusion_env(ops, ordered, plan):
    """Shared precomputation for plan_fusion / verify_fusion: producing-F
    compute map, raw owner byte sizes, packed pre-ranges, in-place
    re-admission EOs and the residency peak bound."""
    produced_at: Dict[int, Tuple[str, int, Optional[Tuple[int, int]]]] = {}
    inplace_eos: set = set()
    peak = None
    if ordered is not None:
        ctx = CheckContext.build(ordered, None, plan, None)
        for name, t in ctx.activations.items():
            eo = ctx.producer_eo(name)
            off = ctx.planned_device_offset(name, post=False)
            rng = (off, off + ctx.aligned_nbytes(name)) if off >= 0 else None
            produced_at[eo] = (name, t.nbytes, rng)
    if isinstance(plan, SwapAwarePlan):
        peak = plan.activation_residency_peak()
        inplace_eos = {d.read_eo for d in plan.schedule.decisions
                       if d.inplace}
    return produced_at, inplace_eos, peak


def plan_fusion(schedule_or_ops, ordered=None, plan=None, *,
                min_block: int = 2) -> FusionPlan:
    """The maximal legal ``Compute`` runs of a lowered schedule.

    A run grows over consecutive ``Compute``/``Free`` ops and splits
    when fusing further would change observable behaviour:

    * *fence* — the next op is a ``SwapOut``/``Prefetch``: transfers keep
      their exact issue point (that is the overlap the plan priced);
    * *hazard* — a ``Free`` already absorbed into the run vacates bytes
      an upcoming producer in the same run would reuse: deferring that
      free past the produce would alias live data;
    * *inplace* — the next compute is an in-place decision's re-admission
      phase (``read_eo``): the fused block must not span the vacated
      window's edge, where the static model re-admits the bytes;
    * *peak* — deferring the run's frees past the next production would
      push residency (canonical bytes + deferred bytes) over the packed
      ``activation_residency_peak()`` the backends assert against.

    ``Free`` ops inside a surviving block are absorbed and replayed at
    the block end; runs shorter than ``min_block`` computes stay eager.
    Optimizer-slot transfers (``OptPrefetch``/``OptSwapOut``) are fences
    exactly like activation transfers — their issue point around the CG
    update is the overlap the plan priced — so a run never spans one.
    The result always satisfies :func:`schedules_equivalent` against the
    original (see :func:`replay_stream`)."""
    from repro_torch.core.plan import (Compute, Free, OptPrefetch, OptSwapOut,
                                       Prefetch, SwapOut)
    ops = _ops_of(schedule_or_ops)
    produced_at, inplace_eos, peak = _fusion_env(ops, ordered, plan)

    blocks: List[FusedBlock] = []
    splits = {"fence": 0, "hazard": 0, "inplace": 0, "peak": 0}
    run_computes: List[int] = []
    run_frees: List[int] = []
    deferred_bytes = 0
    deferred_ranges: List[Tuple[int, int]] = []
    current = 0    # canonical resident bytes (raw, HbmTracker accounting)

    def flush(reason: Optional[str] = None) -> None:
        nonlocal run_computes, run_frees, deferred_bytes, deferred_ranges
        if reason is not None and run_computes:
            splits[reason] += 1
        if len(run_computes) >= min_block:
            blocks.append(FusedBlock(
                index=len(blocks),
                op_indices=tuple(sorted(run_computes + run_frees)),
                compute_indices=tuple(run_computes),
                free_indices=tuple(run_frees)))
        run_computes, run_frees = [], []
        deferred_bytes, deferred_ranges = 0, []

    n_computes = 0
    for i, op in enumerate(ops):
        if isinstance(op, (OptSwapOut, OptPrefetch)):
            # optimizer transfers fence like activation transfers, but
            # touch neither the activation residency counter nor the
            # deferred-free ranges (separate device region)
            flush("fence")
        elif isinstance(op, (SwapOut, Prefetch)):
            flush("fence")
            nb = (ordered.tensors[op.tensor].nbytes
                  if ordered is not None and op.tensor in ordered.tensors
                  else op.nbytes)
            current += nb if isinstance(op, Prefetch) else -nb
        elif isinstance(op, Free):
            nb = (ordered.tensors[op.tensor].nbytes
                  if ordered is not None and op.tensor in ordered.tensors
                  else op.nbytes)
            current -= nb
            if run_computes:
                run_frees.append(i)
                deferred_bytes += nb
                off = op.device_offset
                if off >= 0:
                    deferred_ranges.append((off, off + _align(op.nbytes)))
            # an eager Free between blocks needs no dispatch of its own in
            # spirit, but fusing a computes-less run is pointless
        elif isinstance(op, Compute):
            n_computes += 1
            prod = produced_at.get(op.eo) if op.kind == "F" else None
            if prod is not None:
                name, nb, rng = prod
                if rng is not None and any(
                        not (rhi <= rng[0] or rng[1] <= rlo)
                        for rlo, rhi in deferred_ranges):
                    flush("hazard")
                if (peak is not None and run_computes
                        and current + nb + deferred_bytes > peak):
                    flush("peak")
            if op.eo in inplace_eos and run_computes:
                flush("inplace")
            if prod is not None:
                current += prod[1]
            run_computes.append(i)
    flush()
    return FusionPlan(
        blocks=tuple(blocks), n_ops=len(ops), n_computes=n_computes,
        fence_splits=splits["fence"], hazard_splits=splits["hazard"],
        inplace_splits=splits["inplace"], peak_splits=splits["peak"])


def replay_stream(schedule_or_ops, fusion: FusionPlan) -> Tuple[Any, ...]:
    """The op order a fused replay actually executes: each block's
    computes in order, then its deferred frees, everything else in
    place.  By construction of :func:`plan_fusion` this stream passes
    :func:`schedules_equivalent` against the original."""
    ops = _ops_of(schedule_or_ops)
    first_of: Dict[int, FusedBlock] = {}
    covered: set = set()
    for b in fusion.blocks:
        first_of[min(b.op_indices)] = b
        covered.update(b.op_indices)
    out: List[Any] = []
    for i, op in enumerate(ops):
        b = first_of.get(i)
        if b is not None:
            out.extend(ops[j] for j in b.compute_indices)
            out.extend(ops[j] for j in b.free_indices)
        elif i not in covered:
            out.append(op)
    return tuple(out)


def verify_fusion(fusion: FusionPlan, schedule_or_ops, ordered=None,
                  plan=None, *, peak_bytes: Optional[int] = None
                  ) -> List[Diagnostic]:
    """Independently re-prove a :class:`FusionPlan` legal (the prover is
    not trusted to have been the planner): no block spans a transfer
    fence (``fusion_fence``), no deferred ``Free`` aliases a later
    producer in its block or crosses an in-place re-admission
    (``fusion_hazard``), and deferred residency never exceeds the packed
    peak (``fusion_peak``, overridable via ``peak_bytes`` for tests)."""
    from repro_torch.core.plan import (Compute, Free, OptPrefetch, OptSwapOut,
                                       Prefetch, SwapOut)
    ops = _ops_of(schedule_or_ops)
    produced_at, inplace_eos, peak = _fusion_env(ops, ordered, plan)
    if peak_bytes is not None:
        peak = peak_bytes
    diags: List[Diagnostic] = []

    deferred_until: Dict[int, int] = {}   # free op index -> block end index
    for b in fusion.blocks:
        lo, hi = b.span()
        # membership comes from the typed sets, not the claimed
        # op_indices: a forged block cannot smuggle a transfer past the
        # fence scan by listing it as a "member"
        members = set(b.compute_indices) | set(b.free_indices)
        for i in range(lo, hi + 1):
            if i in members:
                continue
            op = ops[i]
            if isinstance(op, (SwapOut, Prefetch, OptSwapOut, OptPrefetch)):
                diags.append(Diagnostic(
                    SEV_ERROR, "fusion_fence",
                    f"block {b.index} [{lo},{hi}] spans {_describe(op)}: "
                    f"fusing across a transfer fence would move its issue "
                    f"point", op_index=i, tensor=op.tensor))
            else:
                diags.append(Diagnostic(
                    SEV_ERROR, "fusion_hazard",
                    f"block {b.index} [{lo},{hi}] spans foreign op "
                    f"{_describe(op)}", op_index=i,
                    tensor=getattr(op, "tensor", None)))
        # deferred-free vs later-in-block producer ranges
        ranges: List[Tuple[int, Tuple[int, int], str]] = []
        for fi in b.free_indices:
            off = ops[fi].device_offset
            if off >= 0:
                ranges.append((fi, (off, off + _align(ops[fi].nbytes)),
                               ops[fi].tensor))
            deferred_until[fi] = hi
        for ci in b.compute_indices:
            op = ops[ci]
            prod = produced_at.get(op.eo) if op.kind == "F" else None
            if prod is None:
                continue
            name, _nb, rng = prod
            if rng is None:
                continue
            for fi, (flo, fhi), ftensor in ranges:
                if fi < ci and not (fhi <= rng[0] or rng[1] <= flo):
                    diags.append(Diagnostic(
                        SEV_ERROR, "fusion_hazard",
                        f"block {b.index} defers Free({ftensor}) past the "
                        f"producer of {name}, which reuses bytes "
                        f"[{max(flo, rng[0])},{min(fhi, rng[1])})",
                        op_index=fi, tensor=ftensor))
        for ci in b.compute_indices[1:]:
            if ops[ci].eo in inplace_eos:
                diags.append(Diagnostic(
                    SEV_ERROR, "fusion_hazard",
                    f"block {b.index} spans the in-place re-admission at "
                    f"EO {ops[ci].eo}: the vacated-window edge must stay "
                    f"a block boundary", op_index=ci))

    # residency with deferrals: frees charge until their block end
    if peak is not None and ordered is not None:
        current = 0
        deferred: Dict[int, int] = {}   # release-at op index -> bytes
        high = 0
        for i, op in enumerate(ops):
            if isinstance(op, Compute):
                prod = produced_at.get(op.eo) if op.kind == "F" else None
                if prod is not None:
                    current += prod[1]
            elif isinstance(op, Prefetch):
                current += ordered.tensors[op.tensor].nbytes \
                    if op.tensor in ordered.tensors else op.nbytes
            elif isinstance(op, SwapOut):
                current -= ordered.tensors[op.tensor].nbytes \
                    if op.tensor in ordered.tensors else op.nbytes
            elif isinstance(op, Free):
                nb = ordered.tensors[op.tensor].nbytes \
                    if op.tensor in ordered.tensors else op.nbytes
                until = deferred_until.get(i)
                if until is not None and until > i:
                    deferred[until] = deferred.get(until, 0) + nb
                else:
                    current -= nb
            high = max(high, current)
            current -= deferred.pop(i, 0)
        if high > peak:
            diags.append(Diagnostic(
                SEV_ERROR, "fusion_peak",
                f"deferred frees push residency to {high} bytes, over the "
                f"packed activation residency peak ({peak})",
                offsets=(high, peak)))
    return diags


def deps_summary(schedule_or_ops, ordered=None, plan=None) -> Dict[str, Any]:
    """The ``report()["deps"]`` payload: dependence-edge counts, the
    fusion plan summary and the per-transfer static slack table."""
    ops = _ops_of(schedule_or_ops)
    graph = build_dependence_graph(ops, ordered, plan)
    fusion = plan_fusion(ops, ordered, plan)
    slack = transfer_slack(ops)
    return {
        "n_ops": len(ops),
        "edges": graph.edge_counts(),
        "fusion": fusion.summary(),
        "min_prefetch_slack_phases": slack["min_prefetch_slack_phases"],
        "mean_prefetch_slack_phases": slack["mean_prefetch_slack_phases"],
    }
