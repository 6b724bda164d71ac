"""Execution-order-driven proactive host swapping (NNTrainer §6).

The NNTrainer paper's roadmap (§6): "Dynamic off-loading is expected to be
highly efficient because NNTrainer can predict and decide when a buffer is
accessed; thus, we can swap in and out proactively in background."  This
module realises that prediction: the execution-order analysis gives every
saved activation its full access timeline, so the *idle window* — the widest
gap between consecutive accesses — is known statically.

Tensors whose idle window exceeds a threshold (activations of early layers
in a deep stack, which sit untouched through the remaining forward and most
of the backward) are swapped out to host memory right after their last
pre-gap access and prefetched back ``prefetch_margin`` phases before the
first post-gap access.

The schedule produced here is consumed in two places:

* :func:`repro_torch.core.planner.plan_memory_swapped` — plans the device arena
  with swapped tensors *split* into two residency intervals (pre-swap and
  post-prefetch), so the vacated bytes are reusable by other tensors, plus
  a second host-pool arena for the offloaded copies packed by its own
  :class:`repro_torch.core.planner.ArenaAllocator`.  The swap-aware placement
  pass there may lower a decision to an *in-place prefetch*
  (``OffloadDecision.inplace``): the packed arena kept its bytes untouched
  at a stable offset, so the swap moves no data at all;
* :func:`repro_torch.core.plan.lower_schedule` — lowers the decisions (plus the
  compute phases and frees) into the flat, typed
  :class:`repro_torch.core.plan.ExecutionSchedule` that the executor backends
  (:mod:`repro_torch.core.exec.backends`: synchronous ``sim`` replay or the
  ``async`` device-stream backend) replay op by op, with HBM and
  host-pool high-water trackers proving the planned bounds are
  respected.

On the model-config path the decisions lower to a checkpoint policy
(:func:`offload_policy`) that :mod:`repro_torch.core.remat` realises
around each transformer block: offloaded intermediates go to pinned host
memory through saved-tensor hooks and a CUDA copy stream
(:func:`offload_lowering` says so in ``report()``).  On the graph path
they reach the card through the lowered schedule and the copy stream of
:mod:`repro_torch.core.exec.store`.

Knobs (all on :func:`plan_offload`):

``min_idle_phases``
    Minimum width (in EO phases) of the idle window for a tensor to be a
    swap candidate.  Swap-out occupies the phase right after the window
    opens and the prefetch occupies ``prefetch_margin`` phases before it
    closes, so windows narrower than ~3 phases cannot vacate any bytes.
``min_bytes``
    Minimum tensor size.  Small tensors cost a DMA descriptor each but
    reclaim little HBM; the default (1 MiB) matches the DMA-efficiency
    cliff observed on embedded DMA engines and TPU host transfers alike.
``prefetch_margin``
    How many phases before the post-gap access the prefetch is issued.
    Larger margins hide more DMA latency but re-occupy HBM earlier
    (shrinking the vacancy window) — this is the memory-vs-traffic knob
    swept by ``benchmarks/swap_bench.py``.
``hbm_budget_bytes``
    Stop choosing candidates once this many bytes have been reclaimed
    (None = take every candidate).  Candidates are ranked by
    ``nbytes * idle_phases`` (HBM-seconds reclaimed per DMA byte).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.execution_order import OrderedTensors


@dataclasses.dataclass(frozen=True)
class OffloadDecision:
    """One tensor's swap plan.

    ``write_eo`` is the last access *before* the idle window (not
    necessarily the producing write) and ``read_eo`` the first access after
    it; both are real accesses, so the device buffer must be resident at
    both.  Swap-out DMA runs during phase ``write_eo + 1``; the prefetch
    DMA starts at ``prefetch_at_eo`` and must complete by ``read_eo``.
    """

    name: str
    nbytes: int
    write_eo: int
    read_eo: int
    prefetch_at_eo: int
    # Set by the swap-aware placement pass (plan_memory_swapped): the packed
    # arena kept this tensor's bytes untouched at a stable offset through
    # the idle window, so re-residency needs no copy — the decision moves
    # no data (no host slot, no DMA) but keeps the planner's freedom to
    # reuse the bytes.  See SwapAwarePlan.inplace_prefetch_count.
    inplace: bool = False

    @property
    def idle_phases(self) -> int:
        return self.read_eo - self.write_eo

    @property
    def swap_out_eo(self) -> int:
        """Phase whose background DMA moves the tensor out (write_eo + 1)."""
        return self.write_eo + 1

    @property
    def vacates(self) -> bool:
        """True when the split actually frees bytes: the device residency
        intervals [.., write_eo+1] and [prefetch_at_eo, ..] are disjoint."""
        return self.prefetch_at_eo > self.write_eo + 1


@dataclasses.dataclass
class OffloadSchedule:
    decisions: Tuple[OffloadDecision, ...]
    # bytes moved off-device during their idle windows — an upper bound on
    # the arena reduction (the packed arena delta depends on what else can
    # occupy the vacated windows; see SwapAwarePlan.hbm_bytes_saved for the
    # realised number)
    hbm_bytes_saved: int
    dma_bytes: int                      # total device<->host traffic (2x size)
    peak_inflight_prefetch: int

    def names(self) -> Tuple[str, ...]:
        return tuple(d.name for d in self.decisions)

    def decision_for(self, name: str) -> Optional[OffloadDecision]:
        for d in self.decisions:
            if d.name == name:
                return d
        return None


def make_schedule(decisions: Sequence[OffloadDecision]) -> OffloadSchedule:
    """Build a consistent :class:`OffloadSchedule` from a decision set.

    Recomputes the aggregate fields (bytes saved, DMA traffic, peak inflight
    prefetch) so callers can restrict a schedule to a subset of decisions —
    the primitive the schedule/planner co-optimisation loop in
    :mod:`repro_torch.core.plan` iterates on.  Non-vacating decisions are dropped,
    matching :func:`plan_offload`'s own filtering.  In-place decisions stay
    in the schedule (their residency split is part of the packed plan) but
    move no data, so they contribute to no aggregate.
    """
    chosen = tuple(d for d in decisions if d.vacates)
    moved = tuple(d for d in chosen if not d.inplace)
    saved = sum(d.nbytes for d in moved)
    peak = 0
    for d in moved:
        inflight = sum(
            o.nbytes for o in moved
            if o.prefetch_at_eo <= d.prefetch_at_eo <= o.read_eo
        )
        peak = max(peak, inflight)
    return OffloadSchedule(
        decisions=chosen,
        hbm_bytes_saved=saved,
        dma_bytes=2 * saved,
        peak_inflight_prefetch=peak,
    )


def plan_offload(ordered: OrderedTensors, *, min_idle_phases: int = 4,
                 min_bytes: int = 1 << 20, prefetch_margin: int = 2,
                 hbm_budget_bytes: Optional[int] = None) -> OffloadSchedule:
    """Choose saved activations to swap based on their widest EO idle gap.

    Only CREATE-owner activation tensors (``X:`` / ``S:``) qualify — weights
    and derivatives have short or permanent residency.  The idle window is
    the widest gap between *consecutive* accesses, so tensors re-read by
    their consumer's forward right after production are judged by the long
    forward->backward gap, not by ``max_eo - min_eo`` (which would let the
    swap race the consumer read).  Candidates are taken largest
    byte-phase-product first until the HBM budget is met.
    """
    candidates: List[OffloadDecision] = []
    for t in ordered.planned_tensors():
        if not t.name.startswith(("X:", "S:")):
            continue
        if len(t.exec_orders) < 2:
            continue
        write, read = t.largest_gap()
        if read - write < min_idle_phases or t.nbytes < min_bytes:
            continue
        d = OffloadDecision(
            name=t.name, nbytes=t.nbytes, write_eo=write, read_eo=read,
            prefetch_at_eo=max(write + 1, read - prefetch_margin),
        )
        if not d.vacates:
            # the prefetch would start before the swap-out DMA drains:
            # no bytes reclaimed, two transfers wasted — never schedule it
            # (and never count it toward savings or the HBM budget).
            continue
        candidates.append(d)
    # biggest byte-phases product first: most HBM-seconds saved per DMA byte
    candidates.sort(key=lambda d: d.nbytes * d.idle_phases, reverse=True)

    chosen: List[OffloadDecision] = []
    saved = 0
    for d in candidates:
        chosen.append(d)
        saved += d.nbytes
        if hbm_budget_bytes is not None and saved >= hbm_budget_bytes:
            break

    return make_schedule(chosen)


def offload_lowering() -> str:
    """How offload decisions lower in the port: always ``"native"``.

    The reference returns ``"fallback_save"`` when its JAX lacks
    ``save_and_offload_only_these_names`` and the policy degrades to
    device saves.  The port has no such fallback: an offloaded residual is
    copied to host memory (pinned, on a CUDA copy stream, for a tensor on
    the card) and its device bytes are released
    (:mod:`repro_torch.core.remat`).
    """
    return "native"


def offload_policy(names: Sequence[str], *, saved: Sequence[str] = ()):
    """Checkpoint policy offloading ``names`` to host memory and keeping
    ``saved`` on the device; every other intermediate is recomputed (the
    reference's ``save_and_offload_only_these_names``)."""
    from repro_torch.core.remat_policy import CheckpointPolicy
    return CheckpointPolicy(saved=tuple(saved), offloaded=tuple(names))
