"""Memory Planner (NNTrainer §4.2, Algorithm 2) + beyond-paper allocators.

The planner maps each CREATE-mode tensor (post-merge) to a byte offset in a
single arena (the Memory Pool) such that tensors whose execution-order
intervals overlap never share bytes.  Peak memory is known *before*
execution — the property the paper highlights for avoiding OOM crashes.

Every planner implements the :class:`ArenaAllocator` protocol — one
placement abstraction shared by the device arena and the pinned-host pool
(``MemoryPlanConfig.host_planner`` picks the host-side implementation):

* :class:`SortingPlanner` — the paper's Algorithm 2, faithfully: sort by
  ascending ``min(EO)`` (ties: descending ``max(EO)``), then greedily reuse
  the storage of any already-placed tensor whose interval has fully expired.
  We add the size-fit check the pseudo-code leaves implicit (a tensor may
  only reuse a region at least as large as itself).

* :class:`BestFitPlanner` — beyond paper (the paper names fragmentation
  minimisation as future work): interval-overlap-aware offset assignment
  that scans *gaps* between already-placed live tensors and picks the
  tightest fit, falling back to extending the arena.  This is classic
  best-fit address assignment on lifetime intervals (cf. XLA's buffer
  assignment heuristics).

* :class:`SegregatedFitPlanner` — size-class free lists: regions are
  rounded to power-of-two classes and a freed region is reused by the next
  tensor of the same class (LIFO).  Classes make every slot of a class
  interchangeable, so reuse never fails on a few bytes of size mismatch —
  the failure mode of Algorithm 2's exact-fit scan on ragged sizes — at
  the cost of bounded internal padding (< 2x, visible in
  ``Plan.utilization``).

* :class:`BuddyPlanner` — classic binary-buddy allocation over the
  lifetime timeline: blocks split recursively to the requested order and
  freed buddies coalesce, so adjacent small regions can serve one large
  request (which no-coalescing allocators extend the arena for).

* :class:`WorstCasePlanner` — no reuse at all; models a naive tensor-basis
  framework's peak for the Fig. 9 comparison.

All planners return a :class:`Plan` that can be validated (no two live
tensors overlap in [offset, offset+nbytes), every offset ALIGN-aligned)
and queried for peak bytes and fragmentation (:meth:`Plan.utilization`).
"""

from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Dict, List, Optional, Protocol, Set,
                    Tuple, runtime_checkable)

from repro_torch.core.execution_order import OrderedTensors
from repro_torch.core.lifespan import CreateMode, TensorSpec

if TYPE_CHECKING:  # planner <- offload would cycle at runtime
    from repro_torch.core.offload import OffloadSchedule

ALIGN = 64  # byte alignment for every arena slot (cache-line / vector width)


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _size_class(n: int) -> int:
    """Smallest ALIGN * 2^k >= n (the segregated-fit / buddy granularity)."""
    c = ALIGN
    while c < n:
        c *= 2
    return c


@runtime_checkable
class ArenaAllocator(Protocol):
    """The pluggable allocator layer: assign every planned tensor a byte
    offset in one arena such that lifetime-overlapping tensors never share
    bytes.  Implementations are *offline* packers — they see the full EO
    timeline up front — but several (segregated fit, buddy) simulate the
    behaviour of their online counterpart over that timeline, so their
    fragmentation characteristics carry over to a runtime pool."""

    name: str

    def plan(self, ordered: OrderedTensors) -> "Plan":
        ...


@dataclasses.dataclass
class Placement:
    name: str
    offset: int
    nbytes: int          # bytes reserved (region size — may include padding)
    min_eo: int
    max_eo: int
    # bytes actually requested (0 = same as nbytes).  Class-rounding
    # allocators (segregated fit, buddy) reserve more than requested; the
    # difference is internal fragmentation, charged by utilization().
    requested: int = 0

    @property
    def end(self) -> int:
        return self.offset + self.nbytes

    @property
    def live_bytes(self) -> int:
        return self.requested or self.nbytes


@dataclasses.dataclass
class Plan:
    placements: Dict[str, Placement]
    arena_bytes: int
    planner: str
    # bytes NOT in the arena (placeholders: model inputs / labels)
    external_bytes: int = 0
    # optimizer-state offload plan (not ported yet, ROADMAP item 5)
    # attached by compile_plan when MemoryPlanConfig.optim_offload is on;
    # optimizer slots occupy their OWN device region and host pool, so
    # nothing here aliases the activation placements above
    optim: Optional[object] = None

    @property
    def peak_bytes(self) -> int:
        return self.arena_bytes

    @property
    def total_bytes(self) -> int:
        """Arena + externally-held placeholders (the paper's 'ideal' counts
        inputs/labels since they reside in process memory during training)."""
        return self.arena_bytes + self.external_bytes

    def offset_of(self, name: str) -> int:
        return self.placements[name].offset

    def validate(self) -> None:
        """No two tensors with overlapping EO intervals may overlap in bytes,
        every placement is ALIGN-aligned, and nothing exceeds the arena.

        Delegates to the static verifier's aliasing sweep
        (:func:`repro_torch.core.verify.plan_aliasing_diagnostics`) so every
        call site — planners, both compile paths, hand-forged test plans —
        shares one checker; raises :class:`AssertionError` on the first
        finding, preserving the historical contract."""
        from repro_torch.core.verify import plan_aliasing_diagnostics
        diags = plan_aliasing_diagnostics(self)
        if diags:
            raise AssertionError(diags[0].message)

    def utilization(self) -> float:
        """max over time of live requested bytes / arena bytes (1.0 = zero
        fragmentation).  The numerator uses *requested* sizes, so both
        external fragmentation (holes between regions) and internal padding
        (class rounding in segregated fit / buddy) count against it."""
        if not self.placements:
            return 1.0
        events = sorted({p.min_eo for p in self.placements.values()}
                        | {p.max_eo for p in self.placements.values()})
        peak_live = 0
        for t in events:
            live = sum(p.live_bytes for p in self.placements.values()
                       if p.min_eo <= t <= p.max_eo)
            peak_live = max(peak_live, live)
        return peak_live / self.arena_bytes if self.arena_bytes else 1.0


def _planned_and_external(ordered: OrderedTensors) -> Tuple[List[TensorSpec], int]:
    planned = ordered.planned_tensors()
    external = sum(
        t.nbytes for t in ordered.tensors.values()
        if t.create_mode == CreateMode.PLACEHOLDER
    )
    return planned, external


class SortingPlanner:
    """Algorithm 2 — the paper's simple sorting-based planner."""

    name = "sorting"

    def plan(self, ordered: OrderedTensors) -> Plan:
        tensors, external = _planned_and_external(ordered)
        # line 1-4: sort ascending min EO; ties broken by descending max EO
        tensors = sorted(tensors, key=lambda t: (t.min_eo, -t.max_eo))
        placements: Dict[str, Placement] = {}
        order_placed: List[Placement] = []
        arena = 0
        for t in tensors:
            nbytes = _align(t.nbytes)
            reuse: Optional[Placement] = None
            # line 8-13: scan earlier tensors back-to-front for an expired one
            for prev in reversed(order_placed):
                if prev.max_eo < t.min_eo and prev.nbytes >= nbytes:
                    # region fully expired and large enough — but we must also
                    # ensure no *other* live tensor has since been placed there
                    if not self._region_busy(order_placed, prev, t, placements):
                        reuse = prev
                        break
            if reuse is not None:
                pl = Placement(t.name, reuse.offset, nbytes, t.min_eo, t.max_eo)
            else:
                pl = Placement(t.name, arena, nbytes, t.min_eo, t.max_eo)
                arena += nbytes
            placements[t.name] = pl
            order_placed.append(pl)
            t.offset = pl.offset
        plan = Plan(placements, arena, self.name, external)
        plan.validate()
        return plan

    @staticmethod
    def _region_busy(placed: List[Placement], region: Placement,
                     t: TensorSpec, placements: Dict[str, Placement]) -> bool:
        """True if any tensor live during t's interval occupies region bytes."""
        for other in placed:
            if other is region:
                continue
            bytes_overlap = not (
                other.end <= region.offset
                or region.offset + _align(t.nbytes) <= other.offset
            )
            life_overlap = not (other.max_eo < t.min_eo or t.max_eo < other.min_eo)
            if bytes_overlap and life_overlap:
                return True
        return False


class BestFitPlanner:
    """Beyond-paper: best-fit gap search over lifetime intervals.

    For each tensor (sorted by min EO, then size descending), collect the
    offsets blocked by tensors whose lifetime overlaps, then choose the
    smallest gap that fits; extend the arena only when no gap fits.
    """

    name = "bestfit"

    def plan(self, ordered: OrderedTensors) -> Plan:
        tensors, external = _planned_and_external(ordered)
        tensors = sorted(tensors, key=lambda t: (t.min_eo, -t.nbytes))
        placements: Dict[str, Placement] = {}
        arena = 0
        for t in tensors:
            nbytes = _align(t.nbytes)
            blockers = sorted(
                (p for p in placements.values()
                 if not (p.max_eo < t.min_eo or t.max_eo < p.min_eo)),
                key=lambda p: p.offset,
            )
            best_off: Optional[int] = None
            best_gap = None
            cursor = 0
            for b in blockers:
                gap = b.offset - cursor
                if gap >= nbytes and (best_gap is None or gap < best_gap):
                    best_off, best_gap = cursor, gap
                cursor = max(cursor, b.end)
            # trailing space inside current arena
            tail_gap = arena - cursor
            if tail_gap >= nbytes and (best_gap is None or tail_gap < best_gap):
                best_off, best_gap = cursor, tail_gap
            if best_off is None:
                best_off = cursor
                arena = max(arena, best_off + nbytes)
            pl = Placement(t.name, best_off, nbytes, t.min_eo, t.max_eo)
            placements[t.name] = pl
            t.offset = pl.offset
        plan = Plan(placements, arena, self.name, external)
        plan.validate()
        return plan


class SegregatedFitPlanner:
    """Size-class free lists simulated over the EO timeline.

    Regions are rounded up to power-of-two classes; at each allocation the
    expired regions are returned to their class's free list and the request
    is served from its exact class (LIFO — the hottest slot first, like a
    runtime segregated-fit pool would).  Every slot of a class is
    interchangeable, so reuse never fails on a size mismatch; the price is
    internal padding, charged to :meth:`Plan.utilization` via
    ``Placement.requested``.
    """

    name = "segregated"

    def plan(self, ordered: OrderedTensors) -> Plan:
        tensors, external = _planned_and_external(ordered)
        placements: Dict[str, Placement] = {}
        free: Dict[int, List[int]] = {}        # class size -> free offsets
        live: List[Tuple[int, int, int]] = []  # (max_eo, class, offset)
        arena = 0
        for t in sorted(tensors, key=lambda t: (t.min_eo, -t.nbytes, t.name)):
            nbytes = _align(t.nbytes)
            cls = _size_class(nbytes)
            still_live = []
            for entry in live:
                if entry[0] < t.min_eo:
                    free.setdefault(entry[1], []).append(entry[2])
                else:
                    still_live.append(entry)
            live = still_live
            if free.get(cls):
                off = free[cls].pop()
            else:
                off = arena
                arena += cls
            placements[t.name] = Placement(t.name, off, cls, t.min_eo,
                                           t.max_eo, requested=nbytes)
            live.append((t.max_eo, cls, off))
            t.offset = off
        plan = Plan(placements, arena, self.name, external)
        plan.validate()
        return plan


class BuddyPlanner:
    """Binary-buddy allocation simulated over the EO timeline.

    Blocks split recursively down to the requested order and freed buddies
    coalesce back up, so two adjacent freed halves can serve one request of
    their combined size — the reuse that no-splitting/no-coalescing
    allocators miss.  The arena doubles when no block fits (the canonical
    buddy growth rule); ``arena_bytes`` reports the high-water byte span
    actually reserved, not the doubled capacity.
    """

    name = "buddy"

    _MAX_ORDER = 48  # ALIGN << 48 ~ 16 EiB: effectively unbounded

    def plan(self, ordered: OrderedTensors) -> Plan:
        tensors, external = _planned_and_external(ordered)
        placements: Dict[str, Placement] = {}
        free: Dict[int, Set[int]] = {o: set() for o in range(self._MAX_ORDER)}
        live: List[Tuple[int, int, int]] = []  # (max_eo, order, offset)
        self._span = 0          # current pow2 capacity (ALIGN << top order)
        self._top: Optional[int] = None

        for t in sorted(tensors, key=lambda t: (t.min_eo, -t.nbytes, t.name)):
            nbytes = _align(t.nbytes)
            order = (_size_class(nbytes) // ALIGN).bit_length() - 1
            still_live = []
            for entry in live:
                if entry[0] < t.min_eo:
                    self._release(free, entry[2], entry[1])
                else:
                    still_live.append(entry)
            live = still_live
            off = self._alloc(free, order)
            while off is None:
                self._grow(free, order)
                off = self._alloc(free, order)
            placements[t.name] = Placement(t.name, off, ALIGN << order,
                                           t.min_eo, t.max_eo,
                                           requested=nbytes)
            live.append((t.max_eo, order, off))
            t.offset = off
        arena = max((p.end for p in placements.values()), default=0)
        plan = Plan(placements, arena, self.name, external)
        plan.validate()
        return plan

    def _alloc(self, free: Dict[int, Set[int]], order: int) -> Optional[int]:
        for o in range(order, self._MAX_ORDER):
            if free[o]:
                off = min(free[o])   # lowest address first: keeps span tight
                free[o].discard(off)
                while o > order:     # split down, freeing the upper halves
                    o -= 1
                    free[o].add(off + (ALIGN << o))
                return off
        return None

    def _release(self, free: Dict[int, Set[int]], off: int, order: int) -> None:
        while order < self._MAX_ORDER - 1:
            buddy = off ^ (ALIGN << order)
            if buddy in free[order]:
                free[order].discard(buddy)
                off = min(off, buddy)
                order += 1
            else:
                break
        free[order].add(off)

    def _grow(self, free: Dict[int, Set[int]], order: int) -> None:
        if self._top is None:
            self._top = order
            self._span = ALIGN << order
            free[order].add(0)
            return
        # double: the new upper half becomes a free block of the old top
        # order; _release coalesces it with the lower half when that is free
        self._release(free, self._span, self._top)
        self._top += 1
        self._span *= 2


class WorstCasePlanner:
    """No reuse: every tensor gets fresh storage (naive-framework model)."""

    name = "worstcase"

    def plan(self, ordered: OrderedTensors) -> Plan:
        # Include would-be views as separate allocations: a tensor-op-basis
        # framework without lifetime analysis materialises each of them.
        tensors = [
            t for t in ordered.tensors.values()
            if t.create_mode != CreateMode.PLACEHOLDER
        ]
        external = sum(
            t.nbytes for t in ordered.tensors.values()
            if t.create_mode == CreateMode.PLACEHOLDER
        )
        placements: Dict[str, Placement] = {}
        arena = 0
        for t in sorted(tensors, key=lambda t: t.min_eo):
            nbytes = _align(t.nbytes)
            placements[t.name] = Placement(t.name, arena, nbytes, t.min_eo, t.max_eo)
            arena += nbytes
        return Plan(placements, arena, self.name, external)


PLANNERS: Dict[str, type] = {
    "sorting": SortingPlanner,
    "bestfit": BestFitPlanner,
    "segregated": SegregatedFitPlanner,
    "buddy": BuddyPlanner,
    "worstcase": WorstCasePlanner,
}


def get_planner(name: str) -> ArenaAllocator:
    """Instantiate a registered :class:`ArenaAllocator` by name."""
    try:
        return PLANNERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown planner {name!r}: choose from "
            f"{', '.join(sorted(PLANNERS))}") from None


def plan_memory(ordered: OrderedTensors, planner: str = "sorting",
                offload: Optional["OffloadSchedule"] = None,
                host_planner: str = "sorting"):
    """Plan the arena; with an :class:`OffloadSchedule` the plan is
    swap-aware (see :func:`plan_memory_swapped`)."""
    if offload is not None:
        return plan_memory_swapped(ordered, offload, planner=planner,
                                   host_planner=host_planner)
    return get_planner(planner).plan(ordered)


# ---------------------------------------------------------------------------
# Swap-aware planning: swapped tensors vacate their bytes mid-lifetime
# ---------------------------------------------------------------------------

_PRE, _POST, _HOST = "@pre", "@post", "@host"


class _SpecSet:
    """Minimal OrderedTensors-shaped view over an explicit spec list, so the
    interval planners can run on split residency intervals unchanged."""

    def __init__(self, specs: List[TensorSpec], eo_max: int,
                 placeholders: Optional[List[TensorSpec]] = None):
        placeholders = placeholders or []
        self.tensors = {t.name: t for t in list(specs) + placeholders}
        self.merged: Dict[str, str] = {}
        self.eo_max = eo_max
        self.layer_orders: Dict[str, Tuple[int, int, int]] = {}
        self._planned = list(specs)

    def planned_tensors(self) -> List[TensorSpec]:
        return self._planned


@dataclasses.dataclass
class SwapAwarePlan:
    """Device arena planned over *residency* intervals + a host-pool arena.

    A swapped tensor's single lifetime interval is split into two residency
    intervals — ``[first access, write_eo + 1]`` (resident until the
    background swap-out DMA completes) and ``[prefetch_at_eo, last access]``
    (re-resident once the prefetch starts) — so every byte it occupied is
    reusable by the planner during the gap.  The offloaded copy occupies a
    second arena modelling the pinned-host pool for ``[write_eo + 1,
    read_eo]``, packed by its own :class:`ArenaAllocator`
    (``host_planner``).

    The two halves may land at different device offsets (the prefetch is a
    fresh write), but the swap-aware placement pass prefers the *same*
    offset for both when nothing else claims it during the post interval.
    When additionally no other tensor touched those bytes during the whole
    idle window, the data survived in place: the swap needs no host slot
    and no DMA in either direction — an *in-place prefetch*.  Such
    decisions are flagged ``inplace`` on the schedule, listed in
    ``self.inplace``, and counted by ``inplace_prefetch_count``.
    """

    device: Plan
    host: Plan
    schedule: "OffloadSchedule"
    # original tensor name -> its residency placements (1 entry if unsplit)
    residencies: Dict[str, Tuple[Placement, ...]]
    baseline_arena_bytes: int        # same planner, no swapping
    planner: str
    host_planner: str = "sorting"
    # swapped tensors whose gap went unused: no host copy, no DMA
    inplace: Tuple[str, ...] = ()
    # optimizer-state offload plan (not ported yet, ROADMAP item 5),
    # attached by compile_plan when MemoryPlanConfig.optim_offload is on.
    # Its slots are packed into a separate device working region and
    # compressed host pool — activation_residency_peak() and the two
    # arenas above stay optimizer-blind by construction.
    optim: Optional[object] = None

    @property
    def arena_bytes(self) -> int:
        return self.device.arena_bytes

    @property
    def peak_bytes(self) -> int:
        return self.device.arena_bytes

    @property
    def host_pool_bytes(self) -> int:
        return self.host.arena_bytes

    @property
    def hbm_bytes_saved(self) -> int:
        return self.baseline_arena_bytes - self.device.arena_bytes

    @property
    def inplace_prefetch_count(self) -> int:
        return len(self.inplace)

    def swapped_names(self) -> Tuple[str, ...]:
        return tuple(n for n, rs in self.residencies.items() if len(rs) == 2)

    def activation_residency_peak(self) -> int:
        """Peak simultaneously-resident ``X:``/``S:`` bytes over the EO
        timeline — the bound the swap executor's HBM tracker asserts.
        In-place-prefetch tensors never leave the device (their bytes must
        survive the gap untouched), so they count across their full span."""
        inplace = set(self.inplace)
        places: List[Tuple[int, int, int]] = []
        for n, rs in self.residencies.items():
            if not n.startswith(("X:", "S:")):
                continue
            if n in inplace and len(rs) == 2:
                pre, post = sorted(rs, key=lambda r: r.min_eo)
                places.append((pre.min_eo, post.max_eo, pre.nbytes))
            else:
                places.extend((r.min_eo, r.max_eo, r.nbytes) for r in rs)
        events = sorted({p[0] for p in places} | {p[1] for p in places})
        peak = 0
        for eo in events:
            live = sum(n for lo, hi, n in places if lo <= eo <= hi)
            peak = max(peak, live)
        return peak

    def validate(self) -> None:
        """Prove the swap plan sound: residency intervals never share bytes
        while overlapping in time, swapped tensors truly vacate the arena
        during their idle window, every offloaded copy has host bytes
        covering the whole gap, and every in-place prefetch really kept its
        bytes untouched (same offset, gap unused)."""
        self.device.validate()
        self.host.validate()
        inplace = set(self.inplace)
        for d in self.schedule.decisions:
            rs = self.residencies.get(d.name)
            if rs is None or not d.vacates:
                continue
            if len(rs) != 2:
                raise AssertionError(
                    f"{d.name}: expected 2 residency intervals, got {len(rs)}")
            pre, post = sorted(rs, key=lambda r: r.min_eo)
            if pre.max_eo > d.swap_out_eo:
                raise AssertionError(
                    f"{d.name}: pre-swap residency ends at {pre.max_eo}, "
                    f"after swap-out phase {d.swap_out_eo}")
            if post.min_eo < d.prefetch_at_eo:
                raise AssertionError(
                    f"{d.name}: post-swap residency starts at {post.min_eo}, "
                    f"before prefetch phase {d.prefetch_at_eo}")
            for eo in range(d.swap_out_eo + 1, d.prefetch_at_eo):
                if any(r.min_eo <= eo <= r.max_eo for r in rs):
                    raise AssertionError(
                        f"{d.name}: still resident at EO {eo} inside its "
                        f"idle window ({d.swap_out_eo}, {d.prefetch_at_eo})")
            if d.name in inplace:
                if not d.inplace:
                    raise AssertionError(
                        f"{d.name}: in plan.inplace but its schedule "
                        f"decision is not flagged inplace")
                if pre.offset != post.offset:
                    raise AssertionError(
                        f"{d.name}: in-place prefetch with pre offset "
                        f"{pre.offset} != post offset {post.offset}")
                if self._gap_bytes_used(pre, post):
                    raise AssertionError(
                        f"{d.name}: in-place prefetch but another tensor "
                        f"used its bytes during the idle window")
                if d.name + _HOST in self.host.placements:
                    raise AssertionError(
                        f"{d.name}: in-place prefetch must not hold a "
                        f"host-pool slot")
                continue
            hp = self.host.placements.get(d.name + _HOST)
            if hp is None:
                raise AssertionError(f"{d.name}: no host-pool placement")
            if hp.min_eo > d.swap_out_eo or hp.max_eo < d.read_eo:
                raise AssertionError(
                    f"{d.name}: host copy [{hp.min_eo},{hp.max_eo}] does not "
                    f"cover the swap window [{d.swap_out_eo},{d.read_eo}]")

    def _gap_bytes_used(self, pre: Placement, post: Placement) -> bool:
        """True if any other placement touches [pre.offset, pre.end) while
        live strictly inside the idle window (pre.max_eo, post.min_eo)."""
        for p in self.device.placements.values():
            if p is pre or p is post:
                continue
            if p.end <= pre.offset or pre.offset + post.nbytes <= p.offset:
                continue
            if p.min_eo < post.min_eo and p.max_eo > pre.max_eo:
                return True
        return False


def _clone_spec(t: TensorSpec, name: str, orders: Tuple[int, ...]) -> TensorSpec:
    return TensorSpec(name=name, shape=t.shape, dtype=t.dtype,
                      lifespan=t.lifespan, create_mode=CreateMode.CREATE,
                      exec_orders=tuple(sorted(orders)))


def _prefer_same_offset(device: Plan,
                        residencies: Dict[str, Tuple[Placement, ...]]) -> None:
    """Swap-aware tie-breaking pass: re-anchor each swapped tensor's post
    residency at its pre offset when no other live placement claims those
    bytes during the post interval.  Pointer-stable re-residency is what
    makes an in-place prefetch possible at all; when the idle window's
    bytes additionally went unused, the copy itself is elided (see
    :func:`_detect_inplace`).  Only shrinks the arena, never grows it."""
    for name in sorted(residencies):
        rs = residencies[name]
        if len(rs) != 2:
            continue
        pre, post = sorted(rs, key=lambda r: r.min_eo)
        if pre.offset == post.offset:
            continue
        lo, hi = pre.offset, pre.offset + post.nbytes
        conflict = any(
            p is not post and p is not pre
            and not (p.end <= lo or hi <= p.offset)
            and not (p.max_eo < post.min_eo or post.max_eo < p.min_eo)
            for p in device.placements.values())
        if not conflict:
            post.offset = pre.offset
    device.arena_bytes = max((p.end for p in device.placements.values()),
                             default=0)


def _detect_inplace(device: Plan,
                    residencies: Dict[str, Tuple[Placement, ...]],
                    decisions) -> Tuple[str, ...]:
    """Names whose pre/post residencies share an offset AND whose bytes no
    other tensor touched during the idle window: the device data survived,
    so swap-out and prefetch both become no-ops (no host slot, no DMA)."""
    out: List[str] = []
    for d in decisions:
        rs = residencies.get(d.name)
        if rs is None or len(rs) != 2:
            continue
        pre, post = sorted(rs, key=lambda r: r.min_eo)
        if pre.offset != post.offset:
            continue
        used = any(
            p is not pre and p is not post
            and not (p.end <= pre.offset or pre.offset + post.nbytes <= p.offset)
            and p.min_eo < post.min_eo and p.max_eo > pre.max_eo
            for p in device.placements.values())
        if not used:
            out.append(d.name)
    return tuple(out)


def legacy_host_pool_bytes(ordered: OrderedTensors,
                           schedule: "OffloadSchedule") -> int:
    """What the pre-allocator-layer code charged for the host pool: a
    SortingPlanner pack over EVERY offloaded copy's [swap_out, read]
    lifetime — in-place elision ignored.  The baseline the
    fragmentation-aware pool is benchmarked against (BENCH_swap.json
    ``legacy_host_bytes``); honest, because the old packer did reuse bytes
    across disjoint swap windows."""
    host_specs = [
        _clone_spec(ordered.tensors[d.name], d.name + _HOST,
                    (d.swap_out_eo, d.read_eo))
        for d in schedule.decisions if d.vacates
    ]
    return SortingPlanner().plan(_SpecSet(host_specs, ordered.eo_max)).arena_bytes


def plan_memory_swapped(ordered: OrderedTensors, schedule: "OffloadSchedule",
                        planner: str = "sorting",
                        host_planner: str = "sorting") -> SwapAwarePlan:
    """Plan the device arena with the swap schedule applied.

    Decisions whose prefetch would start before the swap-out completes
    (``not d.vacates``) are kept resident — splitting them would reclaim
    nothing and cost two DMA transfers.  After packing, the swap-aware
    placement pass re-anchors post residencies at their pre offsets where
    possible, decisions whose bytes survived the gap untouched are lowered
    to in-place prefetches (no host slot, no DMA), and the host pool is
    packed by its own allocator (``host_planner``) over the remaining
    offloaded copies.
    """
    from repro_torch.core.offload import make_schedule

    # Re-derive in-place flags from this packing: flags riding in on the
    # caller's schedule describe a different arena layout.
    decisions = tuple(
        dataclasses.replace(d, inplace=False) if d.inplace else d
        for d in schedule.decisions)
    by_name = {d.name: d for d in decisions if d.vacates}

    placeholders = [t for t in ordered.tensors.values()
                    if t.create_mode == CreateMode.PLACEHOLDER]
    # Baseline over the SAME tensor universe the swapped re-pack sees
    # (planned owners + placeholders), so hbm_bytes_saved compares like
    # with like.  Planning ``ordered`` directly would let planners that
    # look beyond planned_tensors() (WorstCasePlanner materialises merged
    # views too) report phantom savings that have nothing to do with swaps.
    baseline = get_planner(planner).plan(_SpecSet(
        [_clone_spec(t, t.name, t.exec_orders)
         for t in ordered.planned_tensors()],
        ordered.eo_max, placeholders))
    split_specs: List[TensorSpec] = []
    split_names: Dict[str, Tuple[str, ...]] = {}
    for t in ordered.planned_tensors():
        d = by_name.get(t.name)
        if d is None:
            split_specs.append(_clone_spec(t, t.name, t.exec_orders))
            split_names[t.name] = (t.name,)
            continue
        pre = tuple(o for o in t.exec_orders if o <= d.write_eo) + (d.swap_out_eo,)
        post = (d.prefetch_at_eo,) + tuple(
            o for o in t.exec_orders if o >= d.read_eo)
        split_specs.append(_clone_spec(t, t.name + _PRE, pre))
        split_specs.append(_clone_spec(t, t.name + _POST, post))
        split_names[t.name] = (t.name + _PRE, t.name + _POST)

    device = get_planner(planner).plan(
        _SpecSet(split_specs, ordered.eo_max, placeholders))

    residencies = {
        name: tuple(device.placements[part] for part in parts)
        for name, parts in split_names.items()
    }
    _prefer_same_offset(device, residencies)
    inplace = _detect_inplace(device, residencies, by_name.values())
    if inplace:
        flagged = set(inplace)
        decisions = tuple(
            dataclasses.replace(d, inplace=True) if d.name in flagged else d
            for d in decisions)
    schedule = make_schedule(decisions)

    host_specs = [
        _clone_spec(ordered.tensors[d.name], d.name + _HOST,
                    (d.swap_out_eo, d.read_eo))
        for d in by_name.values() if d.name not in set(inplace)
    ]
    host = get_planner(host_planner).plan(_SpecSet(host_specs, ordered.eo_max))

    plan = SwapAwarePlan(
        device=device, host=host, schedule=schedule,
        residencies=residencies,
        baseline_arena_bytes=baseline.arena_bytes, planner=planner,
        host_planner=host_planner, inplace=inplace,
    )
    plan.validate()
    return plan
