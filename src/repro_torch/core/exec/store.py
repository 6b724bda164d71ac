"""Activation store, residency trackers and the transfer-engine seam.

The store owns *what lives where* (device tier, host tier, alias groups,
byte accounting); it holds no scheduling policy and no opinion about *how*
bytes move.  Data movement is delegated to a :class:`TransferEngine`:

* :class:`SyncHostEngine` — synchronous ``.cpu()`` / ``.to(device)`` round
  trips, the simulated-DMA behaviour the plan validation relies on;
* :class:`DeviceStreamEngine` — the CUDA transfer lane.  Swapped
  activations go to views of ONE pinned host pool at the offsets the host
  planner packed (and the verifier proved); every copy is issued
  non-blocking on a dedicated copy stream when its op is replayed and
  *fenced* by an event only when a consumer reads the tensor, so the DMA
  overlaps the compute issued in between (NNTrainer §6's proactive swap on
  real device streams).  The engine measures the overlap it achieved: how
  many fences found the transfer already complete, the device time each
  fence stalled the compute stream, and the in-flight byte high-water
  mark to compare against the plan's ``peak_inflight_prefetch``.  Its
  optimizer lane issues each ``OptPrefetch``'s H2D of the slot's
  compressed host copy (the optimizer runtime's, or the planned bytes of
  a second pinned pool when the replay updates no optimizer state),
  fenced at the first compute of the slot's read phase, and the updated
  state's D2H.

An owner group (one planned ``X:`` tensor and the layer outputs merged
into it) moves as the storages it holds: an in-place activation and a
flatten view share their producer's storage, so the group is copied once
and its members come back as views of one new buffer, with the dtype,
shape, strides and offset each had.

Backends (:mod:`repro_torch.core.exec.backends`) pick the engine;
everything else — alias groups, owner accounting, high-water marks — is
shared.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Protocol, Set, Tuple

import torch

from repro_torch.core.execution_order import OrderedTensors
from repro_torch.core.lifespan import CreateMode
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class SwapExecStats:
    """What the swap executor actually did during one iteration."""
    swap_outs: int = 0
    prefetches: int = 0
    inplace_prefetches: int = 0    # re-residencies that needed no copy
    dma_bytes: int = 0             # device<->host bytes moved
    late_swap_ins: int = 0         # schedule misses: access before prefetch
    hbm_high_water: int = 0        # peak resident planned-activation bytes
    host_high_water: int = 0       # peak resident host-pool bytes
    planned_peak: Optional[int] = None   # SwapAwarePlan's residency bound
    planned_host_pool: Optional[int] = None  # packed host arena bound
    peak_inflight_prefetch: int = 0      # double-buffer occupancy peak
    # the ops actually executed, in order — equals the compiled
    # ExecutionSchedule.ops exactly when no schedule miss occurred
    replayed_ops: Tuple = ()
    # Python-level dispatches issued while replaying: one per op on the
    # per-op backends
    dispatch_calls: int = 0
    # ---- backend-specific fields (defaults describe the simulated path) ----
    backend: str = "sim"
    # stream engine: peak bytes issued on the copy stream but not yet
    # fenced by a consumer — the measured double-buffer occupancy to hold
    # against the plan's ``peak_inflight_prefetch``
    inflight_high_water: int = 0
    fences: int = 0                # consumer-side waits on in-flight copies
    stalled_fences: int = 0        # fences whose copy had not landed yet
    # fraction of fences that found the transfer already complete (the DMA
    # fully overlapped compute); None when no real transfers were issued
    achieved_overlap: Optional[float] = None
    # debug sanitizer: per-op cross-checks of runtime residency against
    # the static verifier model (0 when the sanitizer is off)
    sanitizer_checks: int = 0
    # wall-clock seconds the backend spent replaying the op list, the
    # end-of-step drain included (0.0 until a run completes)
    wall_time_s: float = 0.0
    # ---- optimizer-state offload ----
    opt_swap_outs: int = 0
    opt_prefetches: int = 0
    opt_dma_bytes: int = 0
    opt_compressed_bytes: int = 0
    opt_device_high_water: int = 0
    # ---- measured bus-time split (stream engines only) ----
    # activation lane: seconds each prefetch spent in flight before its
    # consumer fence (hidden behind dispatched compute) vs seconds the
    # fence actually blocked (exposed on the critical path).  On the card
    # both come from CUDA events read after the step's synchronisation;
    # on the CPU from the host clock against the emulated bus.
    hidden_dma_s: float = 0.0
    exposed_dma_s: float = 0.0
    opt_hidden_dma_s: float = 0.0
    opt_exposed_dma_s: float = 0.0
    opt_fences: int = 0
    opt_stalled_fences: int = 0
    opt_inflight_high_water: int = 0
    # portion of the hidden DMA (both lanes) that elapsed while *another*
    # session held the compute stream (phase-interleaved serving).  On the
    # card: the copy intervals intersected with the other sessions' phase
    # intervals, from CUDA events; on the CPU: the host clock the
    # scheduler reads around each phase
    cross_hidden_dma_s: float = 0.0
    # ---- jit_blocks (the packed device arena, one CUDA graph per block) ----
    graph_captures: int = 0        # blocks captured as CUDA graphs this run
    graph_replays: int = 0         # block graph replays (block calls on CPU)
    arena_copy_bytes: int = 0      # layer outputs copied into arena views
    # card seconds the compute stream waited, before writing arena bytes,
    # for swap-outs still reading them (hazard (a) of the DeviceArena)
    arena_write_wait_s: float = 0.0


class HbmTracker:
    """High-water-mark accounting over the planned activation bytes."""

    def __init__(self):
        self.current = 0
        self.high_water = 0

    def alloc(self, nbytes: int) -> None:
        self.current += nbytes
        self.high_water = max(self.high_water, self.current)

    def free(self, nbytes: int) -> None:
        self.current -= nbytes


# ---------------------------------------------------------------------------
# Owner groups as storages
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Member:
    """How one layer output sits in its storage."""
    dtype: torch.dtype
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


@dataclasses.dataclass(frozen=True)
class HostCopy:
    """One member's host handle: ``buf`` (uint8) holds its storage."""
    buf: Tensor
    member: _Member


def _storages(members: Dict[str, Tensor]
              ) -> List[Tuple[Tensor, Dict[str, _Member]]]:
    """Group ``members`` by the storage they share: one uint8 tensor over
    each whole storage, with the members laid out in it."""
    groups: Dict[int, Tuple[Tensor, Dict[str, _Member]]] = {}
    for name, t in members.items():
        st = t.untyped_storage()
        if st.data_ptr() not in groups:
            base = torch.empty(0, dtype=torch.uint8, device=t.device)
            groups[st.data_ptr()] = (base.set_(st), {})
        groups[st.data_ptr()][1][name] = _Member(
            t.dtype, tuple(t.shape), tuple(t.stride()), t.storage_offset())
    return list(groups.values())


def _members_of(buf: Tensor, members: Dict[str, _Member]
                ) -> Dict[str, Tensor]:
    """The members as views of ``buf``'s storage."""
    st = buf.untyped_storage()
    return {name: torch.empty(0, dtype=m.dtype, device=buf.device).set_(
        st, m.offset, m.shape, m.stride) for name, m in members.items()}


def _by_buffer(handles: Dict[str, HostCopy]
               ) -> List[Tuple[Tensor, Dict[str, _Member]]]:
    groups: Dict[int, Tuple[Tensor, Dict[str, _Member]]] = {}
    for name, h in handles.items():
        groups.setdefault(id(h.buf), (h.buf, {}))[1][name] = h.member
    return list(groups.values())


class HostPool:
    """ONE host buffer of the packed host-pool size, allocated once and
    pinned when the device is a CUDA card (``non_blocking`` copies overlap
    only with pinned memory, and pinning per copy costs milliseconds).
    A swapped owner's host copy is the view at its planned ``host_offset``;
    a transfer with no planned offset (a hand-wired schedule without a
    plan) gets a buffer of its own."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buf: Optional[Tensor] = None

    def _alloc(self, nbytes: int) -> Tensor:
        return torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def reserve(self, nbytes: int) -> None:
        if nbytes and (self.buf is None or self.buf.numel() < nbytes):
            self.buf = None       # release the old pool before pinning anew
            self.buf = self._alloc(nbytes)

    def slot(self, offset: int, nbytes: int) -> Tensor:
        if offset < 0:
            return self._alloc(nbytes)
        if self.buf is None or offset + nbytes > self.buf.numel():
            raise ValueError(
                f"host slot [{offset}, {offset + nbytes}) lies outside the "
                f"reserved pool of "
                f"{0 if self.buf is None else self.buf.numel()} bytes")
        return self.buf[offset:offset + nbytes]


class TransferEngine(Protocol):
    """How activation bytes move between the device and host tiers.

    ``reserve`` sizes the host pools for a plan before its replay (the
    activation pool and the optimizer lane's);
    ``swap_out``/``swap_in`` receive the member tensors (or host handles)
    of one owner group and return the handles of the destination tier;
    ``fence`` makes the consumer wait until a previously issued
    ``swap_in`` of ``owner`` is complete (no-op for synchronous engines
    and for owners with nothing in flight); ``drain`` fences everything
    still outstanding at the end of an iteration, in both lanes.

    The optimizer lane: ``opt_swap_in`` issues the H2D copy of one slot's
    host copy at its scheduled EO and returns the device copies with the
    copy's (start, end) events on the card (None elsewhere); ``srcs`` are
    the optimizer runtime's host tensors of the slot, and without them the
    lane moves the slot's ``host_nbytes`` from its own pool (the planned
    transfer, for a replay that updates no optimizer state).
    ``opt_fence`` makes the consuming compute wait for the copy.
    ``opt_swap_out`` copies a slot's updated state into a host tensor and
    returns the copy's events (None when the copy has already landed).
    Synchronous engines move nothing in flight (a paced one charges the
    bus at the issue).
    """

    name: str

    def reserve(self, host_pool_bytes: int, opt_pool_bytes: int = 0
                ) -> None: ...

    def swap_out(self, owner: str, members: Dict[str, Tensor],
                 nbytes: int, host_offset: int = -1
                 ) -> Dict[str, HostCopy]: ...

    def swap_in(self, owner: str, members: Dict[str, HostCopy],
                nbytes: int) -> Dict[str, Tensor]: ...

    def fence(self, owner: str, stats: SwapExecStats) -> None: ...

    def drain(self, stats: SwapExecStats) -> None: ...

    def begin_phase(self) -> None: ...

    def opt_swap_in(self, owner: str, nbytes: int, host_nbytes: int,
                    stats: SwapExecStats, host_offset: int = -1,
                    srcs: Optional[List[Tensor]] = None
                    ) -> Tuple[List[Tensor], Any]: ...

    def opt_fence(self, owner: str, stats: SwapExecStats) -> None: ...

    def opt_swap_out(self, owner: str, state: Tensor, dst: Tensor
                     ) -> Any: ...


def _check_bus(bus_gbps, bus_latency_s) -> None:
    if bus_gbps is not None and bus_gbps <= 0:
        raise ValueError("bus_gbps must be positive (or None = off)")
    if bus_latency_s < 0:
        raise ValueError("bus_latency_s must be non-negative")


class SyncHostEngine:
    """Synchronous host round trips (simulated DMA, bit-for-bit stable).

    ``.cpu()`` blocks until the device bytes are on the host; ``.to(dev)``
    blocks the other way.  ``device`` is where swapped-in tensors land:
    the CUDA card when None (raises without one).  Nothing is ever in
    flight, so fences are free and the measured overlap is undefined
    (None).

    ``bus_gbps`` (default None = off) applies the same emulated-bus model
    as :class:`DeviceStreamEngine`, but synchronously: a blocking engine
    occupies the bus for the transfer's full duration *at the transfer*,
    so every byte of bus time is exposed wall-clock.  Numerics untouched.
    """

    name = "sync_host"

    def __init__(self, device: DeviceLike = None, bus_gbps=None,
                 bus_latency_s=0.0):
        _check_bus(bus_gbps, bus_latency_s)
        self.device = resolve_device(device)
        self.bus_gbps = bus_gbps
        self.bus_latency_s = bus_latency_s

    def _bus_block(self, nbytes: int) -> None:
        # a blocking engine is queue-depth-1 storage I/O: every access
        # pays the full device latency, then the serial transfer
        if self.bus_gbps is not None and nbytes > 0:
            time.sleep(self.bus_latency_s + nbytes / (self.bus_gbps * 1e9))

    def reserve(self, host_pool_bytes: int, opt_pool_bytes: int = 0
                ) -> None:
        pass

    def swap_out(self, owner: str, members: Dict[str, Tensor],
                 nbytes: int, host_offset: int = -1
                 ) -> Dict[str, HostCopy]:
        out = {}
        for base, laid in _storages(members):
            host = base.cpu()
            out.update({m: HostCopy(host, lay) for m, lay in laid.items()})
        self._bus_block(nbytes)
        return out

    def swap_in(self, owner: str, members: Dict[str, HostCopy],
                nbytes: int) -> Dict[str, Tensor]:
        arrays = {}
        for buf, laid in _by_buffer(members):
            arrays.update(_members_of(buf.to(self.device), laid))
        self._bus_block(nbytes)
        return arrays

    def fence(self, owner: str, stats: SwapExecStats) -> None:
        pass

    def drain(self, stats: SwapExecStats) -> None:
        pass

    def begin_phase(self) -> None:
        pass

    def opt_swap_in(self, owner: str, nbytes: int, host_nbytes: int,
                    stats: SwapExecStats, host_offset: int = -1,
                    srcs: Optional[List[Tensor]] = None
                    ) -> Tuple[List[Tensor], Any]:
        # nothing is ever in flight, but the blocking bus still carries
        # the compressed optimizer image synchronously when paced
        out = [s.to(self.device, copy=True) for s in srcs or ()]
        self._bus_block(host_nbytes)
        return out, None

    def opt_fence(self, owner: str, stats: SwapExecStats) -> None:
        pass

    def opt_swap_out(self, owner: str, state: Tensor, dst: Tensor) -> Any:
        dst.copy_(state)
        self._bus_block(state.numel() * state.element_size())
        return None


# How many phases the host may run ahead of the card.  A swapped-out block
# is reusable once its copy has landed, but the caching allocator only
# learns that when the host allocates; a host that ran the whole forward
# ahead of the card would find no block reusable and take fresh memory for
# every activation, the swaps saving nothing.  The plan's phase model
# frees a swapped tensor's device bytes when its phase completes.
PHASES_AHEAD = 3


# Separates a session's scope from the owner name in a shared engine's keys.
_SCOPE_SEP = "\x1f"


def _scope_of(key: str) -> str:
    return key.split(_SCOPE_SEP, 1)[0] if _SCOPE_SEP in key else ""


@dataclasses.dataclass
class _Copy:
    """One prefetch in flight: its bytes, its issue time on the host clock,
    its emulated ready time, and on the card the copy's start and end
    events."""
    nbytes: int
    issued: float
    ready_at: float
    start: Any = None
    done: Any = None


class DeviceStreamEngine:
    """Async transfers on a dedicated CUDA copy stream.

    * **Swap-out (D2H).** The copy stream waits on an event recorded on
      the compute stream after the producer; the copy into the owner's
      pinned pool slot is issued non-blocking, and ``record_stream`` on
      the device source keeps the caching allocator from reusing its
      block before the copy lands.  The store drops its reference at once
      (the counterpart of the reference's donated ``device_put``).
    * **Prefetch (H2D).** Issued at its scheduled EO on the same copy
      stream, so FIFO order puts it after its own swap-out; the new device
      buffer is allocated on the copy stream, an event marks the copy's
      end, and ``record_stream`` on the compute stream keeps the buffer
      alive until the compute that reads it is done.
    * **Optimizer lane.** ``opt_swap_in`` copies a slot's host copy to
      the device on the copy stream: the optimizer runtime's pinned int8
      blocks and scales (or fp32 state) when it passes them, else the
      slot's ``host_nbytes`` of a second pinned pool at its planned
      offset (a replay that updates no optimizer state still moves the
      planned bytes).  ``opt_fence`` fences it like an activation
      prefetch.  ``opt_swap_out`` issues the updated state's D2H into a
      pinned host tensor on the same stream, after the compute that
      produced it, and returns the events the host waits on before it
      reads the copy (:mod:`repro_torch.core.optim_offload`).
    * **Fence.** At the first read of the owner the compute stream waits
      on the copy's event.  CUDA events around that wait measure the stall
      (``exposed_dma_s``); the part of the copy that ran before the
      compute stream reached the fence is ``hidden_dma_s``; the fence was
      *ready* when the copy had landed by then.  All three are read after
      the step's synchronisation, on the card's clock: the host runs
      phases ahead of the card, so an ``event.query()`` at the host's
      fence would call a copy late that the card never waits for.
    * **Lead.** At each phase boundary the host records an event on the
      compute stream and waits for the one :data:`PHASES_AHEAD` phases
      back, so blocks freed by swap-outs and frees are reused as planned.
      The events also time each phase on the compute stream, tagged with
      the session that ran it: the part of a session's hidden copy time
      that overlapped *another* session's phases is its
      ``cross_hidden_dma_s``, on the card's clock.

    Counters keep the reference's meanings: the stats record's ``fences``
    and ``stalled_fences`` (``opt_*`` for the optimizer lane), the
    engine's ``inflight_high_water`` and ``opt_inflight_high_water``
    (bytes issued on the copy stream but not yet fenced).

    On the CPU (``device="cpu"``) the same class runs its accounting with
    plain copies, and ``bus_gbps`` emulates a narrow bus: every transfer
    occupies one serialized bus for ``nbytes / bus_gbps`` seconds from
    issue, and a fence that arrives before the transfer's completion time
    sleeps out the remainder (landing in ``exposed_dma_s``).  With no
    device given the engine runs on the CUDA card and raises without one;
    a failed copy raises.
    """

    name = "device_stream"

    def __init__(self, device: DeviceLike = None, bus_gbps=None,
                 bus_latency_s=0.0, pool: Optional[HostPool] = None,
                 opt_pool: Optional[HostPool] = None):
        _check_bus(bus_gbps, bus_latency_s)
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and bus_gbps is not None:
            raise ValueError("bus_gbps emulates a bus on the CPU; the card's "
                             "copies run on its own")
        self.bus_gbps = bus_gbps
        self.bus_latency_s = bus_latency_s
        self._bus_free_at = 0.0      # emulated serialized-bus availability
        self.pool = pool if pool is not None else HostPool(self.device)
        self.opt_pool = opt_pool if opt_pool is not None \
            else HostPool(self.device)
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda \
            else None
        # (owner key) -> the prefetch in flight, per lane
        self._inflight: Dict[str, _Copy] = {}
        self._opt_inflight: Dict[str, _Copy] = {}
        # (lane, scope, stats, copy, fence begin, fence end), resolved
        # after the step's synchronisation
        self._timings: List[Tuple[str, str, SwapExecStats, _Copy, Any,
                                  Any]] = []
        self._phase_ends: List[Any] = []
        # (session scope, event at the phase's start) on the compute
        # stream; scope None marks the end of the last phase
        self._phase_log: List[Tuple[Optional[str], Any]] = []
        self.inflight_bytes = 0
        self.inflight_high_water = 0
        self.opt_inflight_bytes = 0
        self.opt_inflight_high_water = 0

    def _bus_schedule(self, nbytes: int) -> float:
        """Reserve the emulated bus for ``nbytes``; returns the completion
        time (0.0 with pacing off).  The bus is serialized: a transfer
        starts when the previous one finishes, like one DMA queue, and a
        transfer issued to an idle bus pays ``bus_latency_s`` first."""
        if self.bus_gbps is None:
            return 0.0
        start = max(time.perf_counter() + self.bus_latency_s,
                    self._bus_free_at)
        self._bus_free_at = start + nbytes / (self.bus_gbps * 1e9)
        return self._bus_free_at

    def _event(self):
        return torch.cuda.Event(enable_timing=True)

    def reserve(self, host_pool_bytes: int, opt_pool_bytes: int = 0
                ) -> None:
        self.pool.reserve(host_pool_bytes)
        self.opt_pool.reserve(opt_pool_bytes)

    def begin_phase(self, scope: str = "") -> None:
        if not self.cuda:
            return
        ev = self._event()
        ev.record(torch.cuda.current_stream(self.device))
        self._phase_ends.append(ev)
        self._phase_log.append((scope, ev))
        if len(self._phase_ends) > PHASES_AHEAD:
            self._phase_ends.pop(0).synchronize()

    # ------------------------------------------------------------- issue
    def swap_out(self, owner: str, members: Dict[str, Tensor],
                 nbytes: int, host_offset: int = -1
                 ) -> Dict[str, HostCopy]:
        return self.swap_out_to(owner, members, nbytes,
                                self.pool.slot(host_offset, nbytes))

    def swap_out_to(self, owner: str, members: Dict[str, Tensor],
                    nbytes: int, slot: Tensor) -> Dict[str, HostCopy]:
        groups = _storages(members)
        need = sum(base.numel() for base, _ in groups)
        if need > slot.numel():
            raise ValueError(
                f"{owner}: its members hold {need} bytes of storage, more "
                f"than its {slot.numel()}-byte host slot")
        out: Dict[str, HostCopy] = {}
        at = 0
        if self.cuda:
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(self.device))
            self.copy_stream.wait_event(produced)
        for base, laid in groups:
            dst = slot[at:at + base.numel()]
            at += base.numel()
            if self.cuda:
                with torch.cuda.stream(self.copy_stream):
                    dst.copy_(base, non_blocking=True)
                base.record_stream(self.copy_stream)
            else:
                dst.copy_(base)
            out.update({m: HostCopy(dst, lay) for m, lay in laid.items()})
        # the d2h copy occupies the emulated bus too; its cost surfaces
        # through the completion times of the transfers queued behind it
        self._bus_schedule(nbytes)
        return out

    def _h2d(self, bufs: List[Tensor]) -> Tuple[List[Tensor], Any, Any]:
        """Device copies of host tensors issued on the copy stream (plain
        clones on the CPU), with the copy's start and end events."""
        if not self.cuda:
            return [b.clone() for b in bufs], None, None
        compute = torch.cuda.current_stream(self.device)
        out = []
        with torch.cuda.stream(self.copy_stream):
            start = self._event()
            start.record()
            for buf in bufs:
                dst = torch.empty(buf.shape, dtype=buf.dtype,
                                  device=self.device)
                dst.copy_(buf, non_blocking=True)
                dst.record_stream(compute)
                out.append(dst)
            done = self._event()
            done.record()
        return out, start, done

    def swap_in(self, owner: str, members: Dict[str, HostCopy],
                nbytes: int) -> Dict[str, Tensor]:
        groups = _by_buffer(members)
        if not groups:
            return {}
        copies, start, done = self._h2d([buf for buf, _ in groups])
        arrays: Dict[str, Tensor] = {}
        for dst, (_, laid) in zip(copies, groups):
            arrays.update(_members_of(dst, laid))
        self._inflight[owner] = _Copy(nbytes, time.perf_counter(),
                                      self._bus_schedule(nbytes), start,
                                      done)
        self.inflight_bytes += nbytes
        self.inflight_high_water = max(self.inflight_high_water,
                                       self.inflight_bytes)
        return arrays

    # ------------------------------------------------ arena regions
    def swap_out_region(self, owner: str, region: Tensor, nbytes: int,
                        host_offset: int = -1) -> Tuple[Tensor, Any]:
        """D2H of one owner group's bytes, ``region`` (a uint8 view of the
        device arena), into its host slot.  Returns the slot and, on the
        card, the copy's end event: until then the region is still being
        read, and no allocator knows it (the arena's hazard list does)."""
        slot = self.pool.slot(host_offset, nbytes)
        if region.numel() > slot.numel():
            raise ValueError(
                f"{owner}: its region holds {region.numel()} bytes, more "
                f"than its {slot.numel()}-byte host slot")
        done = None
        if self.cuda:
            produced = torch.cuda.Event()
            produced.record(torch.cuda.current_stream(self.device))
            self.copy_stream.wait_event(produced)
            with torch.cuda.stream(self.copy_stream):
                slot[:region.numel()].copy_(region, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        else:
            slot[:region.numel()].copy_(region)
        self._bus_schedule(nbytes)
        return slot, done

    def swap_in_region(self, owner: str, slot: Tensor, region: Tensor,
                       nbytes: int, after: Tuple[Any, ...] = ()) -> None:
        """H2D of ``owner``'s host slot into its arena ``region``, issued
        on the copy stream once the compute-stream events ``after`` (the
        last reads of the bytes' previous occupants) have passed, and
        fenced at the consumer like :meth:`swap_in`."""
        if self.cuda:
            for ev in after:
                self.copy_stream.wait_event(ev)
            with torch.cuda.stream(self.copy_stream):
                start = self._event()
                start.record()
                region.copy_(slot[:region.numel()], non_blocking=True)
                done = self._event()
                done.record()
        else:
            region.copy_(slot[:region.numel()])
            start = done = None
        self._inflight[owner] = _Copy(nbytes, time.perf_counter(),
                                      self._bus_schedule(nbytes), start, done)
        self.inflight_bytes += nbytes
        self.inflight_high_water = max(self.inflight_high_water,
                                       self.inflight_bytes)

    def opt_swap_in(self, owner: str, nbytes: int, host_nbytes: int,
                    stats: SwapExecStats, host_offset: int = -1,
                    srcs: Optional[List[Tensor]] = None
                    ) -> Tuple[List[Tensor], Any]:
        if srcs is None:
            srcs = [self.opt_pool.slot(host_offset, max(1, host_nbytes))]
        return self.opt_swap_in_from(owner, host_nbytes, srcs)

    def opt_swap_in_from(self, owner: str, host_nbytes: int,
                         srcs: List[Tensor]) -> Tuple[List[Tensor], Any]:
        if owner in self._opt_inflight:      # already streaming this slot
            return [], None
        out, start, done = self._h2d(srcs)
        self._opt_inflight[owner] = _Copy(host_nbytes, time.perf_counter(),
                                          self._bus_schedule(host_nbytes),
                                          start, done)
        self.opt_inflight_bytes += host_nbytes
        self.opt_inflight_high_water = max(self.opt_inflight_high_water,
                                           self.opt_inflight_bytes)
        return out, (start, done) if self.cuda else None

    def opt_swap_out(self, owner: str, state: Tensor, dst: Tensor) -> Any:
        """D2H of a slot's updated ``state`` into the host tensor ``dst``,
        issued on the copy stream after the compute that produced it;
        returns its (start, end) events (None on the CPU, where the copy
        is done on return)."""
        self._bus_schedule(state.numel() * state.element_size())
        if not self.cuda:
            dst.copy_(state)
            return None
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(self.device))
        self.copy_stream.wait_event(produced)
        start, done = self._event(), self._event()
        with torch.cuda.stream(self.copy_stream):
            start.record()
            dst.copy_(state, non_blocking=True)
            done.record()
        state.record_stream(self.copy_stream)
        return start, done

    # ------------------------------------------------------------- fence
    def _fence(self, lane: str, owner: str, stats: SwapExecStats
               ) -> Optional[_Copy]:
        """Make the consumer wait for ``owner``'s copy in ``lane``; on the
        card the split is read after the step (:meth:`settle`), on the CPU
        from the host clock against the emulated bus here."""
        table = self._inflight if lane == "act" else self._opt_inflight
        copy = table.pop(owner, None)
        if copy is None:
            return None
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            begin, end = self._event(), self._event()
            begin.record(compute)
            compute.wait_event(copy.done)
            end.record(compute)
            self._timings.append((lane, _scope_of(owner), stats, copy,
                                  begin, end))
            return copy
        t0 = time.perf_counter()
        ready = t0 >= copy.ready_at
        if copy.ready_at > 0.0:
            left = copy.ready_at - time.perf_counter()
            if left > 0:
                time.sleep(left)     # emulated bus stall -> exposed
        pre = "" if lane == "act" else "opt_"
        _credit(stats, pre + "hidden_dma_s", t0 - copy.issued)
        _credit(stats, pre + "exposed_dma_s", time.perf_counter() - t0)
        _credit(stats, pre + "stalled_fences", not ready)
        return copy

    def fence(self, owner: str, stats: SwapExecStats) -> None:
        copy = self._fence("act", owner, stats)
        if copy is not None:
            self.inflight_bytes -= copy.nbytes
            stats.fences += 1

    def opt_fence(self, owner: str, stats: SwapExecStats) -> None:
        copy = self._fence("opt", owner, stats)
        if copy is not None:
            self.opt_inflight_bytes -= copy.nbytes
            stats.opt_fences += 1

    def drain(self, stats: SwapExecStats) -> None:
        for owner in list(self._inflight):
            self.fence(owner, stats)
        for owner in list(self._opt_inflight):
            self.opt_fence(owner, stats)
        self.settle()

    def settle(self) -> None:
        """Wait for the card, then credit each fence's measured split to
        the stats record it was fenced for (nothing to do on the CPU)."""
        if not self.cuda:
            return
        end = self._event()
        end.record(torch.cuda.current_stream(self.device))
        self._phase_log.append((None, end))
        torch.cuda.synchronize(self.device)
        self._phase_ends.clear()
        phases = self._phases()
        for lane, scope, st, copy, begin, fenced in self._timings:
            pre = "" if lane == "act" else "opt_"
            dma_s = copy.start.elapsed_time(copy.done) / 1e3
            before = copy.start.elapsed_time(begin) / 1e3
            hidden = min(max(before, 0.0), dma_s)
            _credit(st, pre + "hidden_dma_s", hidden)
            _credit(st, pre + "exposed_dma_s",
                    begin.elapsed_time(fenced) / 1e3)
            _credit(st, pre + "stalled_fences",
                    copy.done.elapsed_time(begin) < 0.0)
            if phases is not None and hidden > 0.0:
                at = phases[0].elapsed_time(copy.start) / 1e3
                st.cross_hidden_dma_s += _overlap(phases[1:], scope, at,
                                                  at + hidden)
        self._timings.clear()
        if not self._inflight and not self._opt_inflight:
            self._phase_log.clear()

    def _phases(self):
        """The logged phases as (first event, starts, ends, scopes), in
        seconds from the first; None when no two sessions shared the
        stream."""
        log = self._phase_log
        if len({scope for scope, _ in log if scope is not None}) < 2:
            return None
        t0 = log[0][1]
        offs = [t0.elapsed_time(ev) / 1e3 for _, ev in log]
        return t0, offs[:-1], offs[1:], [scope for scope, _ in log[:-1]]


def _credit(stats: SwapExecStats, field: str, value) -> None:
    setattr(stats, field, getattr(stats, field) + value)


def _overlap(phases, scope: str, a: float, b: float) -> float:
    """Seconds of [a, b] during which another session's phase ran."""
    starts, ends, scopes = phases
    total = 0.0
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(starts) and starts[i] < b:
        if scopes[i] is not None and scopes[i] != scope:
            total += max(0.0, min(b, ends[i]) - max(a, starts[i]))
        i += 1
    return total


class SessionScopedEngine:
    """Per-session view over one shared :class:`DeviceStreamEngine`.

    Sessions that replay the same compiled plan share the copy stream, so
    one tenant's DMA can hide under another's compute, but owner names and
    host offsets collide across them: this wrapper namespaces owners with
    the session scope, gives the session host pools of its own, and
    tracks which transfers belong to it, so ``drain`` (end of step, or an
    abort after a mid-step kill) fences only this session's copies.
    Per-session ``inflight_bytes`` / high-water marks are kept here.
    On the card the measured split of the session's fences reaches its
    stats record when the shared engine settles, after the wave.
    """

    name = "session_scoped"

    def __init__(self, inner: DeviceStreamEngine, scope: str):
        self.inner = inner
        self.scope = scope
        self.pool = HostPool(inner.device)
        self.opt_pool = HostPool(inner.device)
        self._sizes: Dict[str, int] = {}       # outstanding owner -> bytes
        self._opt_sizes: Dict[str, int] = {}
        self.inflight_bytes = 0
        self.inflight_high_water = 0
        self.opt_inflight_bytes = 0
        self.opt_inflight_high_water = 0

    def _k(self, owner: str) -> str:
        return f"{self.scope}{_SCOPE_SEP}{owner}"

    def reserve(self, host_pool_bytes: int, opt_pool_bytes: int = 0
                ) -> None:
        self.pool.reserve(host_pool_bytes)
        self.opt_pool.reserve(opt_pool_bytes)

    def swap_out(self, owner: str, members: Dict[str, Tensor],
                 nbytes: int, host_offset: int = -1
                 ) -> Dict[str, HostCopy]:
        return self.inner.swap_out_to(self._k(owner), members, nbytes,
                                      self.pool.slot(host_offset, nbytes))

    def swap_in(self, owner: str, members: Dict[str, HostCopy],
                nbytes: int) -> Dict[str, Tensor]:
        arrays = self.inner.swap_in(self._k(owner), members, nbytes)
        if arrays:
            self._sizes[owner] = nbytes
            self.inflight_bytes += nbytes
            self.inflight_high_water = max(self.inflight_high_water,
                                           self.inflight_bytes)
        return arrays

    def fence(self, owner: str, stats: SwapExecStats) -> None:
        self.inner.fence(self._k(owner), stats)
        nbytes = self._sizes.pop(owner, None)
        if nbytes is not None:
            self.inflight_bytes -= nbytes

    def opt_swap_in(self, owner: str, nbytes: int, host_nbytes: int,
                    stats: SwapExecStats, host_offset: int = -1,
                    srcs: Optional[List[Tensor]] = None
                    ) -> Tuple[List[Tensor], Any]:
        if owner in self._opt_sizes:
            return [], None
        if srcs is None:
            srcs = [self.opt_pool.slot(host_offset, max(1, host_nbytes))]
        out = self.inner.opt_swap_in_from(self._k(owner), host_nbytes, srcs)
        self._opt_sizes[owner] = host_nbytes
        self.opt_inflight_bytes += host_nbytes
        self.opt_inflight_high_water = max(self.opt_inflight_high_water,
                                           self.opt_inflight_bytes)
        return out

    def opt_swap_out(self, owner: str, state: Tensor, dst: Tensor) -> Any:
        return self.inner.opt_swap_out(self._k(owner), state, dst)

    def opt_fence(self, owner: str, stats: SwapExecStats) -> None:
        self.inner.opt_fence(self._k(owner), stats)
        host_nbytes = self._opt_sizes.pop(owner, None)
        if host_nbytes is not None:
            self.opt_inflight_bytes -= host_nbytes

    def begin_phase(self) -> None:
        self.inner.begin_phase(self.scope)

    def drain(self, stats: SwapExecStats) -> None:
        """Fence everything *this session* still has in flight.  The host
        waits for nothing here: the fences order the session's last reads
        after its copies on the card, and the shared engine's
        :meth:`DeviceStreamEngine.settle`, once the caller's wave is
        done, waits for the card and credits every session's measured
        split."""
        for owner in list(self._sizes):
            self.fence(owner, stats)
        for owner in list(self._opt_sizes):
            self.opt_fence(owner, stats)

    @property
    def has_inflight(self) -> bool:
        return bool(self._sizes or self._opt_sizes)

    @property
    def next_ready_at(self) -> float:
        """The scheduler's stall-risk signal: when this session's *oldest*
        in-flight transfer completes (0.0 when nothing is pending).
        Prefetches are issued and consumed in EO order, so the next fence
        this session hits is approximately its oldest outstanding
        transfer.  On the CPU the emulated bus's completion time; on the
        card 0.0 once that copy's end event has completed and ``inf``
        before (``event.query()``, read now on the host: a hint, not a
        measurement)."""
        pending = [self.inner._inflight.get(self._k(o)) for o in self._sizes]
        pending += [self.inner._opt_inflight.get(self._k(o))
                    for o in self._opt_sizes]
        pending = [c for c in pending if c is not None]
        if not pending:
            return 0.0
        oldest = min(pending, key=lambda c: c.issued)
        if self.inner.cuda:
            return 0.0 if oldest.done.query() else math.inf
        return min(c.ready_at for c in pending)


class ActivationStore:
    """Layer-output store with device/host tiers and post-merge alias groups.

    Keys are layer names; bytes are accounted per *owner* tensor (the
    post-merge ``X:`` CREATE owner), so an in-place activation output that
    aliases its producer's storage is neither double-counted nor separately
    swapped — swapping an owner moves every alias with it, exactly like one
    arena region moving to host.  The store holds no scheduling logic: the
    executor drives it by replaying the compiled
    :class:`repro_torch.core.plan.ExecutionSchedule` op by op, and the
    wired :class:`TransferEngine` decides whether the bytes move
    synchronously or on the copy stream.
    """

    def __init__(self, ordered: OrderedTensors, hbm: HbmTracker,
                 host_pool: Optional[HbmTracker] = None,
                 engine: Optional[TransferEngine] = None):
        self.ordered = ordered
        self.hbm = hbm
        self.host_pool = host_pool or HbmTracker()
        self.engine = engine or SyncHostEngine()
        self.device: Dict[str, Tensor] = {}
        self.host: Dict[str, HostCopy] = {}
        self.members: Dict[str, Set[str]] = {}     # owner -> layer names
        self.alive: Set[str] = set()               # owners holding HBM bytes
        self._owner_cache: Dict[str, Optional[str]] = {}

    def owner_of(self, lname: str) -> Optional[str]:
        """The planned X: owner accounting this output's bytes, if any."""
        if lname in self._owner_cache:
            return self._owner_cache[lname]
        owner = self.ordered.owner(f"X:{lname}")
        spec = self.ordered.tensors.get(owner)
        tracked = (spec is not None and spec.create_mode == CreateMode.CREATE
                   and spec.merged_into is None)
        self._owner_cache[lname] = owner if tracked else None
        return self._owner_cache[lname]

    def put(self, lname: str, y: Tensor) -> None:
        self.device[lname] = y
        owner = self.owner_of(lname)
        if owner is None:
            return
        self.members.setdefault(owner, set()).add(lname)
        if owner not in self.alive:
            self.alive.add(owner)
            self.hbm.alloc(self.ordered.tensors[owner].nbytes)

    def get(self, lname: str, stats: SwapExecStats) -> Tensor:
        if lname in self.device:
            owner = self.owner_of(lname)
            if owner is not None:
                # consumer read: fence any prefetch still in flight for
                # this alias group (no-op on the synchronous engine)
                self.engine.fence(owner, stats)
            return self.device[lname]
        owner = self.owner_of(lname)
        if owner is not None and lname in self.host:
            # The schedule was wrong (or margins too tight): blocking swap-in.
            stats.late_swap_ins += 1
            self.swap_in(owner, stats)
            self.engine.fence(owner, stats)
            return self.device[lname]
        raise KeyError(f"activation {lname!r} neither on device nor host")

    def swap_out(self, owner: str, stats: SwapExecStats,
                 host_offset: int = -1) -> None:
        nbytes = self.ordered.tensors[owner].nbytes
        moved = {}
        for m in self.members.get(owner, ()):
            if m in self.device:
                moved[m] = self.device.pop(m)
        self.host.update(self.engine.swap_out(owner, moved, nbytes,
                                              host_offset))
        self.alive.discard(owner)
        self.hbm.free(nbytes)
        self.host_pool.alloc(nbytes)
        stats.swap_outs += 1
        stats.dma_bytes += nbytes

    def swap_in(self, owner: str, stats: SwapExecStats) -> None:
        nbytes = self.ordered.tensors[owner].nbytes
        moved = {}
        for m in self.members.get(owner, ()):
            if m in self.host:
                moved[m] = self.host.pop(m)
        self.device.update(self.engine.swap_in(owner, moved, nbytes))
        self.alive.add(owner)
        self.hbm.alloc(nbytes)
        self.host_pool.free(nbytes)
        stats.prefetches += 1
        stats.dma_bytes += nbytes

    def free_owner(self, owner: str) -> None:
        on_host = False
        for m in self.members.get(owner, ()):
            self.device.pop(m, None)
            on_host |= self.host.pop(m, None) is not None
        if on_host:
            self.host_pool.free(self.ordered.tensors[owner].nbytes)
        if owner in self.alive:
            self.alive.discard(owner)
            self.hbm.free(self.ordered.tensors[owner].nbytes)


# ---------------------------------------------------------------------------
# The packed device arena (jit_blocks)
# ---------------------------------------------------------------------------

def _span_bytes(m: _Member) -> int:
    """Bytes from a member's first element to the end of its last."""
    esize = m.dtype.itemsize
    if 0 in m.shape:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(m.shape, m.stride))) * esize


def _contiguous(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(strides))


def _overlaps(a: Tuple[int, int], lo: int, hi: int) -> bool:
    return a[0] < hi and lo < a[1]


class DeviceArena:
    """ONE device buffer of the plan's packed arena bytes, allocated once
    and kept by its backend across runs.  Every planned ``X:`` owner group
    lives in it as typed views at the offset the packer chose and the
    verifier proved, so every activation has the same address in every
    step: what a CUDA graph needs, since it bakes in the address of every
    tensor it reads.

    The verifier proves the offsets free of overlap in EO order, not in
    stream time, and no caching allocator's ``record_stream`` stands
    guard over the arena's bytes, so the arena orders the two streams
    itself:

    (a) a swap-out's D2H reads its region on the copy stream after the
        compute stream has moved on: the first compute-stream write into
        those bytes waits on the copy's end event (:meth:`before_write`);
    (b) a prefetch's H2D writes its region on the copy stream: it waits on
        a compute-stream event recorded when each earlier occupant of
        those bytes was freed, after its last read (:meth:`vacate`,
        :meth:`last_reads`).

    On the CPU every copy is done when it returns, and neither list is
    kept.
    """

    def __init__(self, device: torch.device, nbytes: int):
        self.device = device
        self.nbytes = nbytes
        self.cuda = device.type == "cuda"
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self._reading: List[Tuple[int, int, Any]] = []
        self._vacated: List[Tuple[int, int, Any]] = []
        self._waits: List[Tuple[Any, Any]] = []

    @property
    def base(self) -> int:
        return self.buf.data_ptr()

    def region(self, offset: int, nbytes: int) -> Tensor:
        """The uint8 view of ``[offset, offset + nbytes)``."""
        if offset < 0 or offset + nbytes > self.nbytes:
            raise ValueError(
                f"arena region [{offset}, {offset + nbytes}) lies outside "
                f"the {self.nbytes}-byte arena")
        return self.buf[offset:offset + nbytes]

    def view(self, offset: int, member: _Member) -> Tensor:
        """``member`` (its offset counted in elements from ``offset``) as
        a typed view of the arena."""
        esize = member.dtype.itemsize
        if offset % esize:
            raise ValueError(
                f"arena offset {offset} is not aligned to {member.dtype} "
                f"({esize}-byte elements)")
        at = offset + member.offset * esize
        if member.offset < 0 or at + _span_bytes(member) > self.nbytes:
            raise ValueError(
                f"a {member.dtype} view of shape {member.shape} at byte "
                f"{at} lies outside the {self.nbytes}-byte arena")
        return torch.empty(0, dtype=member.dtype, device=self.device).set_(
            self.buf.untyped_storage(), at // esize, member.shape,
            member.stride)

    def holds(self, t: Tensor) -> bool:
        return (t.device == self.buf.device
                and t.untyped_storage().data_ptr() == self.base)

    # ---------------------------------------------------------- hazards
    def reading(self, lo: int, hi: int, done: Any) -> None:
        """(a) a D2H is reading ``[lo, hi)`` until ``done``."""
        if done is not None:
            self._reading.append((lo, hi, done))

    def before_write(self, lo: int, hi: int) -> None:
        """(a) make the compute stream wait for every D2H still reading
        bytes of ``[lo, hi)``; later compute work is ordered after it."""
        if not self._reading:
            return
        hits = [r for r in self._reading if _overlaps(r, lo, hi)]
        if not hits:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"arena bytes [{lo}, {hi}) are written inside a CUDA-graph "
                f"capture while a swap-out still reads them: the block's "
                f"writes must be ordered after the copy at its entry")
        stream = torch.cuda.current_stream(self.device)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record(stream)
        for r in hits:
            stream.wait_event(r[2])
        end.record(stream)
        self._waits.append((begin, end))
        self._reading = [r for r in self._reading
                         if not _overlaps(r, lo, hi)]

    def vacate(self, lo: int, hi: int) -> None:
        """(b) ``[lo, hi)`` was freed: its occupant's last read is queued
        on the compute stream before this point."""
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._vacated.append((lo, hi, ev))

    def last_reads(self, lo: int, hi: int) -> Tuple[Any, ...]:
        """(b) the events an H2D into ``[lo, hi)`` must wait for; once the
        copy stream has waited, later copies are ordered after them."""
        hits = tuple(r[2] for r in self._vacated if _overlaps(r, lo, hi))
        if hits:
            self._vacated = [r for r in self._vacated
                             if not _overlaps(r, lo, hi)]
        return hits

    def settle(self) -> float:
        """The card has finished the step's work: nothing is in flight.
        Returns the seconds the compute stream waited in
        :meth:`before_write` since the last settle (card clock)."""
        waited = sum(b.elapsed_time(e) for b, e in self._waits) / 1e3
        self._waits.clear()
        self._reading.clear()
        self._vacated.clear()
        return waited


class ArenaActivationStore(ActivationStore):
    """The activation store over a :class:`DeviceArena`.

    ``offsets`` maps each planned owner to its (pre, post) byte offsets:
    where its producer writes it, and where its prefetch lands it (equal
    when it never leaves the device).  The owner's producer output is
    copied into the typed view at the head of its region (``put``; the
    copy's bytes are counted in ``copy_bytes``); a member merged into it
    (an in-place activation, a flatten view) already lies in that region
    and is kept as the view it is.  A swap moves the region's bytes, and
    the members come back as views at the post offset with the dtype,
    shape, strides and offset each had.  Byte accounting is the base
    store's, unchanged."""

    def __init__(self, ordered: OrderedTensors, hbm: HbmTracker,
                 arena: DeviceArena, offsets: Dict[str, Tuple[int, int]],
                 engine: "DeviceStreamEngine"):
        super().__init__(ordered, hbm, engine=engine)
        self.arena = arena
        self.offsets = offsets
        self.at: Dict[str, int] = {}          # owner -> where its bytes are
        self.layout: Dict[str, _Member] = {}  # member -> place in its region
        self.slots: Dict[str, Tensor] = {}    # owner -> host slot, swapped
        self.copy_bytes = 0
        # (member, layout, bytes copied) of each arena put, while a block
        # is recorded
        self.log: Optional[List[Tuple[str, _Member, int]]] = None

    def region_of(self, owner: str) -> Tuple[int, int]:
        """``owner``'s bytes as ``[lo, hi)``: where they are while it is
        resident, where its producer writes them before."""
        lo = self.at[owner] if owner in self.alive else self.offsets[owner][0]
        return lo, lo + self.ordered.tensors[owner].nbytes

    def put(self, lname: str, y: Tensor) -> None:
        owner = self.owner_of(lname)
        if owner is None:
            super().put(lname, y)
            return
        lo, hi = self.region_of(owner)
        esize = y.element_size()
        off = y.data_ptr() - self.arena.base - lo
        copied = 0
        if self.arena.holds(y) and 0 <= off and off % esize == 0 and \
                off + y.numel() * esize <= hi - lo:
            member = _Member(y.dtype, tuple(y.shape), tuple(y.stride()),
                             off // esize)
            view = y
        else:
            # the group's first bytes, or a merged member computed out of
            # place (the analysis proved the bytes it overwrites dead)
            if y.numel() * esize > hi - lo:
                raise ValueError(
                    f"{lname}: {y.numel() * esize} bytes do not fit "
                    f"{owner}'s {hi - lo}-byte arena region")
            member = _Member(y.dtype, tuple(y.shape),
                             _contiguous(tuple(y.shape)), 0)
            self.arena.before_write(lo, hi)
            view = self.arena.view(lo, member)
            view.copy_(y)
            copied = y.numel() * esize
        self._placed(lname, owner, lo, member, copied)
        super().put(lname, view)

    def _placed(self, lname: str, owner: str, lo: int, member: _Member,
                copied: int) -> None:
        self.at[owner] = lo
        self.layout[lname] = member
        self.copy_bytes += copied
        if self.log is not None:
            self.log.append((lname, member, copied))

    def replay_put(self, lname: str, member: _Member, copied: int) -> None:
        """The books of a put a replayed block graph made: ``lname`` is
        the view ``member`` of its owner's region, ``copied`` bytes were
        copied into it on the card."""
        owner = self.owner_of(lname)
        lo = self.region_of(owner)[0]
        self._placed(lname, owner, lo, member, copied)
        super().put(lname, self.arena.view(lo, member))

    def swap_out(self, owner: str, stats: SwapExecStats,
                 host_offset: int = -1) -> None:
        lo, hi = self.region_of(owner)
        nbytes = hi - lo
        slot, done = self.engine.swap_out_region(
            owner, self.arena.region(lo, nbytes), nbytes, host_offset)
        self.arena.reading(lo, hi, done)
        self.slots[owner] = slot
        for m in self.members.get(owner, ()):
            if self.device.pop(m, None) is not None:
                self.host[m] = HostCopy(slot, self.layout[m])
        self.alive.discard(owner)
        self.hbm.free(nbytes)
        self.host_pool.alloc(nbytes)
        stats.swap_outs += 1
        stats.dma_bytes += nbytes

    def swap_in(self, owner: str, stats: SwapExecStats) -> None:
        lo = self.offsets[owner][1]
        nbytes = self.ordered.tensors[owner].nbytes
        self.engine.swap_in_region(
            owner, self.slots.pop(owner), self.arena.region(lo, nbytes),
            nbytes, self.arena.last_reads(lo, lo + nbytes))
        for m in self.members.get(owner, ()):
            if self.host.pop(m, None) is not None:
                self.device[m] = self.arena.view(lo, self.layout[m])
        self.at[owner] = lo
        self.alive.add(owner)
        self.hbm.alloc(nbytes)
        self.host_pool.free(nbytes)
        stats.prefetches += 1
        stats.dma_bytes += nbytes

    def free_owner(self, owner: str) -> None:
        if owner in self.alive:
            self.arena.vacate(*self.region_of(owner))
        self.slots.pop(owner, None)
        super().free_owner(owner)
