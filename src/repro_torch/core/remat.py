"""Block checkpointing under a memory plan's keep / recompute / offload
policy: the port's realisation of ``jax.checkpoint(body, policy=...)``
around each transformer block (``repro/models/transformer.py:
_scan_blocks``).

:func:`checkpoint` runs a block with autograd recording and a
``torch.autograd.graph.saved_tensors_hooks`` pair, which sees every tensor
autograd saves for the backward (a residual) and decides by its storage:

* a residual that :func:`tag` named with a **kept** name stays on the
  device;
* one named with an **offloaded** name is copied to host memory at its
  first save (pinned, non-blocking on a CUDA copy stream behind an event)
  and its device bytes are released when the block returns; the backward
  copies it back on the copy stream and the compute stream waits for that
  copy before it reads it;
* every other residual, untagged or named with a name the plan drops, is
  not kept: the first backward read of one replays the block from its
  saved input and takes the replay's residuals, in save order, as
  ``torch.utils.checkpoint`` (non-reentrant) does.  The replay stops at
  the last residual it has to supply.

As in JAX, a name decides only residuals: a tagged tensor that no backward
reads (the reference's ``mlp_out``, which only an addition consumes) is
never saved, whatever the plan says of it.

The replay must not recompute what the plan keeps or offloads.  Torch
records a graph node by running its op, so the ops whose outputs carry
the plan's names are autograd Functions that save only their inputs and
compute their own backward (the flash and SwiGLU kernels, the rotary q
projection); each computes its output through :func:`produce`, which in a
replay hands back the forward's kept (or fetched) output instead of
running again.  A kernel is therefore launched again only for a name the
plan recomputes.

``torch.utils.checkpoint`` itself is not used: its hooks drop every
residual, and its selective mode (``create_selective_checkpoint_contexts``)
keeps the outputs of dispatcher ops by op, which sees neither the kernels
(``ctypes`` launches) nor a name, and cannot offload.  There is no random
op in a block, so no RNG state is carried into the replay; a graph is
backpropagated once (``retain_graph`` is not supported).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.remat_policy import KEEP, OFFLOAD, CheckpointPolicy

_local = threading.local()
_copy_streams: Dict[torch.device, "torch.cuda.Stream"] = {}


class _StopReplay(Exception):
    """Raised by the replay's pack hook once it has what it needs."""


def _key(t: torch.Tensor) -> Tuple[torch.device, int]:
    return t.device, t.untyped_storage().data_ptr()


def _storage_flat(t: torch.Tensor) -> torch.Tensor:
    """A 1-D tensor of t's dtype over the whole of t's storage."""
    storage = t.untyped_storage()
    n = storage.nbytes() // t.element_size()
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        storage, 0, (n,), (1,))


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    if device not in _copy_streams:
        _copy_streams[device] = torch.cuda.Stream(device)
    return _copy_streams[device]


@dataclasses.dataclass
class _Stash:
    """One tagged storage the policy keeps or offloads."""
    name: str
    decision: str
    base: Optional[torch.Tensor]            # the device tensor (None once
    nbytes: int                             # an offloaded copy is issued)
    saved: bool = False                     # a residual points into it
    device: Optional[torch.device] = None
    host: Optional[torch.Tensor] = None     # the offloaded copy
    d2h_done: Any = None                    # CUDA events of the round trip
    device_copy: Optional[torch.Tensor] = None
    h2d_done: Any = None


@dataclasses.dataclass
class RegionStats:
    """What one block's checkpoint held for its backward, in bytes, and
    the CUDA event pair around each wait of the compute stream for a
    fetched copy (:func:`fence_wait_ms` reads them)."""
    input_bytes: int = 0
    kept: Dict[str, int] = dataclasses.field(default_factory=dict)
    offloaded: Dict[str, int] = dataclasses.field(default_factory=dict)
    dropped_residuals: int = 0
    replays: int = 0
    fences: List[Tuple[Any, Any]] = dataclasses.field(default_factory=list)


class Region:
    """One block's checkpoint: the forward's residual handles, the kept
    and offloaded tensors, and the replay that rebuilds the rest."""

    def __init__(self, policy: CheckpointPolicy, fn: Callable, args,
                 prev: Optional["Region"] = None):
        self.policy = policy
        self.fn = fn
        self.args = tuple(a.detach().requires_grad_(a.requires_grad)
                          if isinstance(a, torch.Tensor) else a
                          for a in args)
        self.prev = prev
        self.mode = "forward"
        self.stats = RegionStats(input_bytes=sum(
            a.untyped_storage().nbytes() for a in self.args
            if isinstance(a, torch.Tensor) and a.is_floating_point()))
        self._stash: Dict[Tuple[torch.device, int], _Stash] = {}
        self._outputs: List[torch.Tensor] = []   # producer outputs, forward
        # producer call -> (stash key, shape, stride, offset) of the
        # output a replay hands back instead of computing it
        self._held: Dict[int, tuple] = {}
        self._n_packs = 0
        self._n_produced = 0
        self._dropped: Dict[int, Tuple[torch.Size, torch.dtype]] = {}
        self._recomputed: Dict[int, torch.Tensor] = {}

    # ---------------------------------------------------------- forward
    def tag(self, name: str, x: torch.Tensor) -> torch.Tensor:
        decision = self.policy.decision(name)
        if self.mode != "forward" or decision not in (KEEP, OFFLOAD):
            return x
        key = _key(x)
        if key not in self._stash:
            self._stash[key] = _Stash(name, decision, x,
                                      x.untyped_storage().nbytes(),
                                      device=x.device)
            for j, out in enumerate(self._outputs):
                if _key(out) == key:
                    self._held[j] = (key, out.shape, out.stride(),
                                     out.storage_offset())
        return x

    def produce(self, compute: Callable[[], torch.Tensor]) -> torch.Tensor:
        j = self._n_produced
        self._n_produced += 1
        if self.mode == "forward":
            out = compute()
            self._outputs.append(out)
            return out
        held = self._held.get(j)
        if held is None:
            return compute()
        key, shape, stride, offset = held
        return self._device_tensor(self._stash[key]).as_strided(
            shape, stride, offset).detach()

    def _pack_forward(self, t: torch.Tensor):
        i = self._n_packs
        self._n_packs += 1
        stash = self._stash.get(_key(t))
        if stash is None:
            self._dropped[i] = (t.shape, t.dtype)
            return ("recompute", i)
        if not stash.saved:
            stash.saved = True
            into = self.stats.kept if stash.decision == KEEP \
                else self.stats.offloaded
            into[stash.name] = into.get(stash.name, 0) + stash.nbytes
            if stash.decision == OFFLOAD:
                self._offload(stash)
        if stash.decision == KEEP:
            return (KEEP, t)
        return (OFFLOAD, _key(t), t.shape, t.stride(), t.storage_offset())

    def _offload(self, stash: _Stash) -> None:
        """Copy the stash's whole storage to the host: pinned, on the copy
        stream behind the compute stream's work so far, for a CUDA one."""
        base = stash.base
        flat = _storage_flat(base)
        if base.device.type != "cuda":
            stash.host = flat.clone()
            return
        stream = _copy_stream(base.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(base.device))
        stash.host = torch.empty(flat.shape, dtype=flat.dtype,
                                 pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            stash.host.copy_(flat, non_blocking=True)
            stash.d2h_done = torch.cuda.Event()
            stash.d2h_done.record(stream)
        base.record_stream(stream)

    def _finish_forward(self) -> None:
        """Let go of what the backward does not need: the producers'
        outputs, the device copies of offloaded tensors, and kept tags
        that no residual points into."""
        self.mode = "saved"
        self._outputs = []
        for key, stash in list(self._stash.items()):
            if not stash.saved:
                del self._stash[key]
            elif stash.decision == OFFLOAD:
                stash.base = None
        self._held = {j: h for j, h in self._held.items()
                      if h[0] in self._stash}
        self.stats.dropped_residuals = len(self._dropped)

    # --------------------------------------------------------- backward
    def prefetch(self) -> None:
        """Start copying this block's offloaded tensors back."""
        for stash in self._stash.values():
            if stash.decision == OFFLOAD and stash.device_copy is None:
                self._fetch(stash)

    def _fetch(self, stash: _Stash) -> None:
        host = stash.host
        if stash.d2h_done is None:          # not a CUDA tensor
            stash.device_copy = host
            return
        stream = _copy_stream(stash.device)
        with torch.cuda.stream(stream):
            stream.wait_event(stash.d2h_done)
            stash.device_copy = torch.empty(host.shape, dtype=host.dtype,
                                            device=stash.device)
            stash.device_copy.copy_(host, non_blocking=True)
            stash.h2d_done = torch.cuda.Event()
            stash.h2d_done.record(stream)

    def _device_tensor(self, stash: _Stash) -> torch.Tensor:
        if stash.decision == KEEP:
            return stash.base
        if stash.device_copy is None:
            self._fetch(stash)
        if stash.h2d_done is not None:
            current = torch.cuda.current_stream(stash.device_copy.device)
            before = torch.cuda.Event(enable_timing=True)
            after = torch.cuda.Event(enable_timing=True)
            before.record(current)
            current.wait_event(stash.h2d_done)
            after.record(current)
            self.stats.fences.append((before, after))
            stash.device_copy.record_stream(current)
            stash.h2d_done = None
        return stash.device_copy

    def _unpack(self, handle):
        kind = handle[0]
        if kind == KEEP:
            return handle[1]
        if kind == OFFLOAD:
            _, key, shape, stride, offset = handle
            return self._device_tensor(self._stash[key]).as_strided(
                shape, stride, offset)
        i = handle[1]
        if self.mode == "saved":
            self._replay()
        if i not in self._recomputed:
            raise RuntimeError("a checkpointed block's residual was read "
                               "twice: backward through it runs once")
        return self._recomputed.pop(i)

    def _replay(self) -> None:
        self.mode = "replay"
        self.stats.replays += 1
        self.prefetch()
        if self.prev is not None:
            self.prev.prefetch()
        self._n_packs = 0
        self._n_produced = 0
        last = max(self._dropped)
        prev_region = getattr(_local, "region", None)
        _local.region = self
        try:
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(
                        lambda t: self._pack_replay(t, last), _no_unpack):
                self.fn(*self.args)
        except _StopReplay:
            pass
        finally:
            _local.region = prev_region
        self.mode = "replayed"
        if len(self._recomputed) != len(self._dropped):
            raise RuntimeError("the replay did not rebuild every residual")

    def _pack_replay(self, t: torch.Tensor, last: int):
        i = self._n_packs
        self._n_packs += 1
        meta = self._dropped.get(i)
        if meta is not None:
            if (t.shape, t.dtype) != meta:
                raise RuntimeError(
                    f"replay saved {tuple(t.shape)} {t.dtype} where the "
                    f"forward saved {tuple(meta[0])} {meta[1]}: the block "
                    "is not deterministic in what it saves")
            self._recomputed[i] = t
        if i == last:
            raise _StopReplay
        return None


def _no_unpack(_):
    raise RuntimeError("a replay's own graph is never backpropagated")


def _current() -> Optional[Region]:
    return getattr(_local, "region", None)


def tag(name: str, x: torch.Tensor) -> torch.Tensor:
    """Name ``x`` for the active block's policy; the identity outside a
    checkpointed block (no autograd, or no remat)."""
    region = _current()
    return x if region is None else region.tag(name, x)


def produce(compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``compute()``, except in a replay where the forward's output of
    this call was kept or offloaded: then that output, back on the
    device."""
    region = _current()
    return compute() if region is None else region.produce(compute)


# ``jax.checkpoint`` without a policy: no tagged intermediate kept, so the
# block is rebuilt from its input in the backward (the reference's mamba,
# mLSTM and sLSTM blocks)
FULL_RECOMPUTE = CheckpointPolicy()


def checkpoint(policy: CheckpointPolicy, fn: Callable, *args,
               prev: Optional[Region] = None):
    """``fn(*args)`` under ``policy``; returns (fn's result, its Region).

    ``prev`` is the region of the block before (the next one backward):
    its offloaded tensors are prefetched when this block's backward
    starts."""
    region = Region(policy, fn, args, prev)
    for obs in getattr(_local, "observers", ()):
        obs.append(region.stats)
    outer = _current()
    _local.region = region
    try:
        with torch.autograd.graph.saved_tensors_hooks(region._pack_forward,
                                                      region._unpack):
            out = fn(*args)
    finally:
        _local.region = outer
    region._finish_forward()
    return out, region


def fence_wait_ms(stats: List[RegionStats]) -> float:
    """The time the compute stream stood still waiting for fetched copies
    in these regions' backwards, in ms: the sum over fences of the time
    between the event recorded before the wait and the one after it (call
    once the backwards have finished on the card)."""
    return sum(before.elapsed_time(after)
               for s in stats for before, after in s.fences)


@contextlib.contextmanager
def observe_regions():
    """Collect the :class:`RegionStats` of every block that
    :func:`checkpoint` runs in the ``with`` body (a region's stats fill in
    as its forward saves and its backward replays; the regions themselves
    are not held, so their tensors go with their graphs)."""
    found: List[RegionStats] = []
    observers = getattr(_local, "observers", ())
    _local.observers = observers + (found,)
    try:
        yield found
    finally:
        _local.observers = observers
