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
  mark to compare against the plan's ``peak_inflight_prefetch``.

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

import dataclasses
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
    # end-of-step synchronisation included (0.0 until a run completes)
    wall_time_s: float = 0.0
    # ---- optimizer-state offload (not ported yet: ROADMAP item 5) ----
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
    # portion of hidden_dma_s that elapsed while *another* session held
    # the compute slot (phase-interleaved serving, not ported yet)
    cross_hidden_dma_s: float = 0.0


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

    ``reserve`` sizes the host pool for a plan before its replay;
    ``swap_out``/``swap_in`` receive the member tensors (or host handles)
    of one owner group and return the handles of the destination tier;
    ``fence`` makes the consumer wait until a previously issued
    ``swap_in`` of ``owner`` is complete (no-op for synchronous engines
    and for owners with nothing in flight); ``drain`` fences everything
    still outstanding at the end of an iteration.
    """

    name: str

    def reserve(self, host_pool_bytes: int) -> None: ...

    def swap_out(self, owner: str, members: Dict[str, Tensor],
                 nbytes: int, host_offset: int = -1
                 ) -> Dict[str, HostCopy]: ...

    def swap_in(self, owner: str, members: Dict[str, HostCopy],
                nbytes: int) -> Dict[str, Tensor]: ...

    def fence(self, owner: str, stats: SwapExecStats) -> None: ...

    def drain(self, stats: SwapExecStats) -> None: ...

    def begin_phase(self) -> None: ...


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

    def reserve(self, host_pool_bytes: int) -> None:
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


# How many phases the host may run ahead of the card.  A swapped-out block
# is reusable once its copy has landed, but the caching allocator only
# learns that when the host allocates; a host that ran the whole forward
# ahead of the card would find no block reusable and take fresh memory for
# every activation, the swaps saving nothing.  The plan's phase model
# frees a swapped tensor's device bytes when its phase completes.
PHASES_AHEAD = 3


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

    Counters keep the reference's meanings: the stats record's ``fences``
    and ``stalled_fences``, the engine's ``inflight_high_water`` (bytes
    issued on the copy stream but not yet fenced).

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
                 bus_latency_s=0.0, pool: Optional[HostPool] = None):
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
        self.copy_stream = torch.cuda.Stream(self.device) if self.cuda \
            else None
        # owner -> (nbytes, issued, emulated ready time, start, done)
        self._inflight: Dict[str, Tuple[int, float, float, Any, Any]] = {}
        # (stats, copy start, copy done, fence begin, fence end) events,
        # resolved after the step's synchronisation
        self._timings: List[Tuple[SwapExecStats, Any, Any, Any, Any]] = []
        self._phase_ends: List[Any] = []
        self.inflight_bytes = 0
        self.inflight_high_water = 0

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

    def reserve(self, host_pool_bytes: int) -> None:
        self.pool.reserve(host_pool_bytes)

    def begin_phase(self) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._phase_ends.append(ev)
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

    def swap_in(self, owner: str, members: Dict[str, HostCopy],
                nbytes: int) -> Dict[str, Tensor]:
        groups = _by_buffer(members)
        if not groups:
            return {}
        arrays: Dict[str, Tensor] = {}
        start = done = None
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                start = self._event()
                start.record()
                for buf, laid in groups:
                    dst = torch.empty(buf.numel(), dtype=torch.uint8,
                                      device=self.device)
                    dst.copy_(buf, non_blocking=True)
                    dst.record_stream(compute)
                    arrays.update(_members_of(dst, laid))
                done = self._event()
                done.record()
        else:
            for buf, laid in groups:
                arrays.update(_members_of(buf.clone(), laid))
        self._inflight[owner] = (nbytes, time.perf_counter(),
                                 self._bus_schedule(nbytes), start, done)
        self.inflight_bytes += nbytes
        self.inflight_high_water = max(self.inflight_high_water,
                                       self.inflight_bytes)
        return arrays

    # ------------------------------------------------------------- fence
    def fence(self, owner: str, stats: SwapExecStats) -> None:
        entry = self._inflight.pop(owner, None)
        if entry is None:
            return
        nbytes, issued, ready_at, start, done = entry
        t0 = time.perf_counter()
        self.inflight_bytes -= nbytes
        stats.fences += 1
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            begin, end = self._event(), self._event()
            begin.record(compute)
            compute.wait_event(done)
            end.record(compute)
            self._timings.append((stats, start, done, begin, end))
            return
        ready = t0 >= ready_at
        if ready_at > 0.0:
            left = ready_at - time.perf_counter()
            if left > 0:
                time.sleep(left)     # emulated bus stall -> exposed
        stats.hidden_dma_s += t0 - issued
        stats.exposed_dma_s += time.perf_counter() - t0
        stats.stalled_fences += not ready

    def drain(self, stats: SwapExecStats) -> None:
        for owner in list(self._inflight):
            self.fence(owner, stats)
        self.settle()

    def settle(self) -> None:
        """Wait for the card, then credit each fence's measured split to
        the stats record it was fenced for (nothing to do on the CPU)."""
        if not self.cuda:
            return
        torch.cuda.synchronize(self.device)
        self._phase_ends.clear()
        for st, start, done, begin, end in self._timings:
            dma_s = start.elapsed_time(done) / 1e3
            before = start.elapsed_time(begin) / 1e3
            st.hidden_dma_s += min(max(before, 0.0), dma_s)
            st.exposed_dma_s += begin.elapsed_time(end) / 1e3
            st.stalled_fences += done.elapsed_time(begin) < 0.0
        self._timings.clear()


class SessionScopedEngine:
    """Per-session view over one shared :class:`DeviceStreamEngine`.

    Sessions that replay the same compiled plan share the copy stream, so
    one tenant's DMA can hide under another's compute, but owner names and
    host offsets collide across them: this wrapper namespaces owners with
    the session scope, gives the session a host pool of its own, and
    tracks which transfers belong to it, so ``drain`` (end of step, or an
    abort after a mid-step kill) fences only this session's copies.
    Per-session ``inflight_bytes`` / high-water marks are kept here.
    """

    name = "session_scoped"

    def __init__(self, inner: DeviceStreamEngine, scope: str):
        self.inner = inner
        self.scope = scope
        self.pool = HostPool(inner.device)
        self._sizes: Dict[str, int] = {}       # outstanding owner -> bytes
        self.inflight_bytes = 0
        self.inflight_high_water = 0

    def _k(self, owner: str) -> str:
        return f"{self.scope}\x1f{owner}"

    def reserve(self, host_pool_bytes: int) -> None:
        self.pool.reserve(host_pool_bytes)

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

    def begin_phase(self) -> None:
        self.inner.begin_phase()

    def drain(self, stats: SwapExecStats) -> None:
        """Fence everything *this session* still has in flight."""
        for owner in list(self._sizes):
            self.fence(owner, stats)
        self.inner.settle()


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
