"""Pluggable executor backends replaying the lowered ExecutionSchedule.

One interpreter, two realisations of its transfer ops:

* :class:`SimulatedBackend` (``"sim"``, the default) — synchronous host
  round trips through :class:`repro_torch.core.exec.store.SyncHostEngine`;
  bit-for-bit the accounting the planner validation suite gates on;
* :class:`AsyncDeviceBackend` (``"async"``) — every ``SwapOut`` /
  ``Prefetch`` op is issued as a non-blocking copy on a dedicated CUDA copy
  stream (:class:`repro_torch.core.exec.store.DeviceStreamEngine`) into
  or out of one pinned host pool, *dispatched* at its scheduled EO and
  fenced by an event only when the consumer computes, so DMA overlaps the
  compute in between.  The backend measures ``inflight_high_water``
  (achieved double-buffer occupancy), the achieved-overlap fraction and
  the hidden/exposed DMA time against the plan's
  ``peak_inflight_prefetch`` — see :meth:`AsyncDeviceBackend.report`.

The reference's third backend, ``"jit_blocks"`` (each proven-fusable
``Compute`` run dispatched as one compiled call), is not ported yet: its
counterpart replays each ``FusedBlock`` as one CUDA-graph replay over a
packed device arena, so that every tensor sits at a fixed address (the
next item of the ROADMAP's queue A).  Asking for it raises
``NotImplementedError``.

Optimizer-state transfers (``OptPrefetch`` / ``OptSwapOut``, from
``MemoryPlanConfig(optim_offload=True)``) are replayed by both backends:
each prefetch is issued to the engine's optimizer lane at its EO and
fenced at the first ``Compute`` of its read EO, and the working region's
residency is held to the packed optimizer plan.  A replay given an
:class:`repro_torch.core.optim_offload.OffloadedStep` (``optim=``)
updates the optimizer state at those ops: the prefetch moves the slot's
host copy, and at ``OptSwapOut``, once the layer's grads are final, the
step runs the AdamW update and sends the new state back.  Without one
the lane moves the planned bytes and updates nothing.

Both backends replay the compiled op list *verbatim*:
``SwapExecStats.replayed_ops == lowered.ops`` is gated per backend, so a
backend cannot silently skip or reorder a planned transfer.

Backends only replay *verified* schedules: a plan-backed schedule that has
not passed the static verifier (:mod:`repro_torch.core.verify`) is
verified on admission and refused (``ScheduleVerificationError``) if
unsound.  A debug sanitizer mode (``sanitize=True``) additionally steps the
verifier's :class:`repro_torch.core.verify.StaticResidencyModel` alongside
the real :class:`ActivationStore` and cross-checks device residency after
every replayed op.

The replay runs where its inputs are: CUDA tensors on the card, CPU
tensors (the tests) on the host.  Where the execution-order analysis
merged an activation's output into its input (an ``MV`` view), the
activation is computed into its input's storage, so the two names hold
one buffer as they hold one arena slot.  Gradients accumulate into
buffers allocated at the start of the replay, so their bytes are one
fixed block, not a staircase rising under the activations.
"""

from __future__ import annotations

import time
from typing import (Any, Callable, Dict, List, Optional, Protocol, Tuple,
                    Union, runtime_checkable)

import torch

from repro_torch.core import inplace
from repro_torch.core.exec.layers import (_needs_deriv, _param_owner,
                                          layer_calc_derivative,
                                          layer_calc_gradient, layer_forward,
                                          loss_derivative, loss_forward)
from repro_torch.core.exec.store import (ActivationStore, DeviceStreamEngine,
                                         HbmTracker, HostPool, SwapExecStats,
                                         SyncHostEngine, TransferEngine)
from repro_torch.core.execution_order import (OrderedTensors,
                                              compute_execution_order)
from repro_torch.core.graph import LOSS_KINDS, WEIGHTED_KINDS, LayerGraph
from repro_torch.core.offload import OffloadSchedule

Tensor = torch.Tensor


@runtime_checkable
class ExecutorBackend(Protocol):
    """One way to execute a lowered :class:`ExecutionSchedule`.

    ``run`` performs one training iteration — replaying the op list
    verbatim — and returns ``(loss, grads, SwapExecStats)``; ``report``
    summarises what the last run did (transfer counts, high-water marks,
    and for real-stream backends the achieved overlap).
    """

    name: str

    def run(self, graph: LayerGraph, params, x, label, *,
            schedule: OffloadSchedule,
            ordered: Optional[OrderedTensors] = None,
            plan=None, lowered=None, mask=None
            ) -> Tuple[Tensor, Dict[str, Dict[str, Tensor]],
                       SwapExecStats]: ...

    def report(self) -> Dict[str, Any]: ...


class _ComputeEnv:
    """The ``Compute``-op interpreter, decoupled from the ActivationStore.

    All layer math and backward-state threading (saved contexts, pending
    derivatives, gradient accumulation) lives here, parameterised over
    ``get``/``put`` activation accessors, which the backends wire to the
    live :class:`ActivationStore` (fencing on read).  ``aliased(layer,
    input)`` says whether the store holds the two in one owner group: an
    activation whose output is merged into its input runs in place.

    Saved contexts hold ``("@act", name)`` references into the store, not
    tensors, so a swap moves the residual too; nothing the store holds is
    written in place except by that merged activation, whose input the
    analysis proved dead after it.
    """

    def __init__(self, graph: LayerGraph, params, label, mask, *,
                 get: Callable[[str], Tensor],
                 put: Callable[[str, Tensor], None],
                 aliased: Callable[[str, str], bool]):
        self.graph = graph
        self.params = params
        self.label = label
        self.mask = mask
        self.get = get          # (layer name) -> activation tensor
        self.put = put          # (layer name, tensor) -> None
        self.aliased = aliased
        self.ctxs: Dict[str, Any] = {}
        self.derivs: Dict[str, Tensor] = {}
        self.pending_dxs: Dict[str, List[Tuple[str, Tensor]]] = {}
        self.pending_cd: Dict[str, Tuple[Tensor, List[str]]] = {}
        # one zeroed buffer per trainable parameter, filled by the CG phases
        self._grad_bufs = {
            owner: {k: torch.zeros_like(w) for k, w in params[owner].items()}
            for owner in {_param_owner(graph, l) for l in graph.layers
                          if l.trainable and l.weight_shapes()}}
        self._grad_owners: List[str] = []
        self.loss_val = None

    @property
    def grads(self) -> Dict[str, Dict[str, Tensor]]:
        """The gradients of every owner a CG phase reached."""
        return {o: self._grad_bufs[o] for o in self._grad_owners}

    def resolve_ctx(self, ctx: Any) -> Any:
        return tuple(
            self.get(e[1])
            if isinstance(e, tuple) and len(e) == 2 and e[0] == "@act"
            else e
            for e in ctx
        )

    def _forward(self, l, xs, p):
        if l.kind == "activation" and self.aliased(l.name, l.inputs[0]):
            y = inplace.apply_activation_(l.attrs["fn"], xs[0])
            return y, (y,)
        return layer_forward(l, xs, p)

    def step(self, op) -> None:
        """Execute one ``Compute`` op (kind "F" / "CG" / "CD")."""
        graph, params, label, mask = \
            self.graph, self.params, self.label, self.mask
        l = graph.layer(op.layer)
        lname, kind = op.layer, op.kind
        if kind == "F":
            if l.kind in LOSS_KINDS:
                self.loss_val = loss_forward(
                    l.kind, self.get(l.inputs[0]), label, mask)
            else:
                xs = [self.get(i) for i in l.inputs]
                p = params.get(_param_owner(graph, l))
                y, ctx = self._forward(l, xs, p)
                self.put(lname, y)
                # keep saved activations by *reference* into the
                # store, so a swap moves the residual too (same
                # bytes in a real arena)
                sym = []
                for e in ctx:
                    hit = next(
                        (i for i, xi in enumerate(xs) if e is xi),
                        None)
                    if hit is not None:
                        sym.append(("@act", l.inputs[hit]))
                    elif e is y:
                        sym.append(("@act", lname))
                    else:
                        sym.append(e)
                self.ctxs[lname] = tuple(sym)
        elif kind == "CG":
            if l.kind in LOSS_KINDS:
                pred = l.inputs[0]
                self.derivs[pred] = loss_derivative(
                    l.kind, self.get(pred), label, mask)
            else:
                dy = self.derivs.pop(lname, None)
                if dy is not None:
                    if l.trainable and l.weight_shapes():
                        p = params.get(_param_owner(graph, l))
                        g = layer_calc_gradient(
                            l, self.resolve_ctx(self.ctxs[lname]), dy, p)
                        owner = _param_owner(graph, l)
                        for k, gk in g.items():
                            self._grad_bufs[owner][k].add_(gk)
                        if owner not in self._grad_owners:
                            self._grad_owners.append(owner)
                    upstream_needed = [
                        i for i in l.inputs
                        if i != "__input__" and _needs_deriv(graph, i)
                    ]
                    if not upstream_needed:
                        pass
                    elif l.kind in WEIGHTED_KINDS:
                        # A weighted layer's saved input has a F+CG
                        # lifespan — it is freed (or swapped) right
                        # after this phase — so its derivative is
                        # computed here, on the same resident
                        # context the CG just used, and *published*
                        # at the adjacent CD phase
                        # (EO_CD = EO_CG + 1).
                        p = params.get(_param_owner(graph, l))
                        dxs = layer_calc_derivative(
                            l, self.resolve_ctx(self.ctxs[lname]), dy, p)
                        self.pending_dxs[lname] = [
                            (inp, dx)
                            for inp, dx in zip(l.inputs, dxs)
                            if inp != "__input__"
                            and inp in upstream_needed
                        ]
                    else:
                        # In-place / pool / view layers have F+CD
                        # contexts (e.g. max-pool argmax source,
                        # activation output) — residency and
                        # prefetches target the CD phase.
                        self.pending_cd[lname] = (dy, upstream_needed)
        else:  # CD: compute deferred derivatives, publish D:<inp>
            dxs_out = self.pending_dxs.pop(lname, [])
            if lname in self.pending_cd:
                dy, upstream_needed = self.pending_cd.pop(lname)
                p = params.get(_param_owner(graph, l))
                dxs = layer_calc_derivative(
                    l, self.resolve_ctx(self.ctxs[lname]), dy, p)
                dxs_out = [
                    (inp, dx) for inp, dx in zip(l.inputs, dxs)
                    if inp != "__input__" and inp in upstream_needed
                ]
            for inp, dx in dxs_out:
                # never +=: the first derivative may be a tensor another
                # phase still refers to
                if inp in self.derivs:
                    self.derivs[inp] = self.derivs[inp] + dx
                else:
                    self.derivs[inp] = dx


def _check_opt_high_water(plan, stats: SwapExecStats) -> None:
    """Assert the replayed optimizer residency against the packed region
    (the optimizer-lane analogue of the activation residency-peak gate)."""
    optim = getattr(plan, "optim", None)
    if optim is not None \
            and stats.opt_device_high_water > optim.device_peak_bytes:
        raise AssertionError(
            f"optimizer working region exceeded the packed peak: "
            f"{stats.opt_device_high_water} > {optim.device_peak_bytes} "
            f"bytes")


class ScheduleCursor:
    """Resumable replay of one lowered schedule, preemptible at phase
    boundaries.

    Produced by :meth:`_ReplayBackend.start` (which runs the same verified
    admission as :meth:`run` — a cursor never exists for an unverified
    plan-backed schedule).  :meth:`advance` executes exactly one *phase*
    (every op sharing one EO: prefetches, the compute, swap-outs, frees)
    and returns True while phases remain; the phase boundary is the
    natural preemption point for interleaving sessions, because all of
    this phase's DMA has been *issued* but need not be *fenced* until a
    later phase computes.

    After the last phase, :meth:`result` returns ``(loss, grads, stats)``
    with the end-of-run drain, high-water assertions and stats
    finalisation.  :meth:`abort` abandons a step mid-flight: this cursor's
    in-flight transfers are fenced and every activation reference is
    dropped.

    ``stats.wall_time_s`` accumulates only the time spent *inside*
    ``advance``/``result`` (host clock): under interleaving, the time a
    session spends preempted is other tenants' work, not this step's.

    ``optim`` (an :class:`~repro_torch.core.optim_offload.OffloadedStep`)
    makes the optimizer ops update the optimizer state: the step's new
    params are its ``new_params`` once the cursor finished.
    """

    def __init__(self, backend: "_ReplayBackend", graph: LayerGraph,
                 params, x, label, *, schedule: OffloadSchedule,
                 ordered: OrderedTensors, plan, lowered, mask,
                 engine: TransferEngine, sanitizer, optim=None):
        self.backend = backend
        self.graph = graph
        self.schedule = schedule
        self.ordered = ordered
        self.plan = plan
        self.lowered = lowered
        self.engine = engine
        self.sanitizer = sanitizer
        self.optim = optim
        self.stats = SwapExecStats(backend=backend.name)
        self.stats.inplace_prefetches = sum(
            1 for d in schedule.decisions if d.inplace)
        self.hbm = HbmTracker()
        self.store = ActivationStore(ordered, self.hbm, engine=engine)
        self.store.device["__input__"] = x
        store = self.store

        def aliased(a: str, b: str) -> bool:
            owner = store.owner_of(a)
            return owner is not None and owner == store.owner_of(b)

        self.env = _ComputeEnv(graph, params, label, mask,
                               get=lambda n: store.get(n, self.stats),
                               put=store.put, aliased=aliased)
        self._replayed: List[Any] = []
        self._inflight = 0
        self._opt_resident = 0
        self._done_at: Dict[int, int] = {}
        self._opt_fence_at: Dict[int, List[str]] = {}
        self._retired_eo = -1
        # phase groups: runs of ops sharing one EO, in schedule order
        self._phases: List[List[Tuple[int, Any]]] = []
        cur_eo = None
        for i, op in enumerate(lowered.ops):
            if cur_eo is None or op.eo != cur_eo:
                self._phases.append([])
                cur_eo = op.eo
            self._phases[-1].append((i, op))
        self._next_phase = 0
        self._finished = False
        self.aborted = False
        self.last_advance_s = 0.0
        self._result: Optional[Tuple] = None

    # ------------------------------------------------------------ driving
    @property
    def phases_total(self) -> int:
        return len(self._phases)

    @property
    def phases_done(self) -> int:
        return self._next_phase

    @property
    def has_inflight_dma(self) -> bool:
        """True while this cursor has issued-but-unfenced transfers —
        the condition under which another session's compute hides them."""
        return bool(getattr(self.engine, "has_inflight", False)
                    or getattr(self.engine, "inflight_bytes", 0)
                    or getattr(self.engine, "opt_inflight_bytes", 0))

    @torch.no_grad()
    def advance(self) -> bool:
        """Execute one phase; True while more phases remain."""
        if self._finished:
            return False
        t0 = time.perf_counter()
        self.engine.begin_phase()
        for op_index, op in self._phases[self._next_phase]:
            self._exec_op(op, op_index)
        self._next_phase += 1
        self.last_advance_s = time.perf_counter() - t0
        self.stats.wall_time_s += self.last_advance_s
        if self._next_phase >= len(self._phases):
            self._finish()
            return False
        return True

    def result(self):
        """``(loss, grads, stats)`` — only after the cursor is exhausted."""
        if not self._finished or self._result is None:
            raise RuntimeError(
                "ScheduleCursor.result() before the cursor finished"
                + (" (aborted)" if self.aborted else ""))
        return self._result

    def abort(self) -> None:
        """Abandon the step at a phase boundary (mid-step kill): fence this
        session's in-flight transfers and release every activation
        reference.  The cursor yields no result."""
        if self._finished:
            return
        self.engine.drain(self.stats)
        self._release()
        self._finished = True
        self.aborted = True

    def _release(self) -> None:
        """Drop every activation, saved context and gradient buffer the
        replay holds.  The compute env's accessors close over this cursor,
        a reference cycle that only the cyclic collector would free: a
        finished step's device memory must not wait for it."""
        self.store.device.clear()
        self.store.host.clear()
        self.store.alive.clear()
        self.env = None

    # ----------------------------------------------------------- op body
    def _exec_op(self, op, op_index: int) -> None:
        from repro_torch.core.plan import (Compute, Free, OptPrefetch,
                                           OptSwapOut, Prefetch, SwapOut)

        stats, store = self.stats, self.store
        if isinstance(op, OptPrefetch):
            # optimizer working state lands in its own device region; the
            # replay accounts residency and bus traffic, issues the H2D of
            # the host copy *now* and fences it at the first Compute of
            # its read EO, so the copy hides behind the compute in between
            self._opt_resident += op.nbytes
            stats.opt_device_high_water = max(
                stats.opt_device_high_water, self._opt_resident)
            stats.opt_prefetches += 1
            stats.opt_dma_bytes += op.host_nbytes
            if self.optim is not None:
                self.optim.prefetch(self.engine, _slot_layer(op.tensor),
                                    stats, op.host_offset)
            else:
                self.engine.opt_swap_in(op.tensor, op.nbytes,
                                        op.host_nbytes, stats,
                                        op.host_offset)
            self._opt_fence_at.setdefault(op.read_eo, []).append(op.tensor)
            self._replayed.append(op)
        elif isinstance(op, OptSwapOut):
            if self.optim is not None:
                # the layer's CG phase is done: its grads are final
                layer = _slot_layer(op.tensor)
                self.optim.update(self.engine, layer,
                                  self.env.grads.get(layer))
            self._opt_resident -= op.nbytes
            stats.opt_swap_outs += 1
            stats.opt_dma_bytes += op.nbytes
            stats.opt_compressed_bytes += op.host_nbytes
            self._replayed.append(op)
        elif isinstance(op, Prefetch):
            if op.tensor in store.alive:
                return  # late swap-in already brought it back
            store.swap_in(op.tensor, stats)
            self._inflight += op.nbytes
            self._done_at[op.read_eo] = \
                self._done_at.get(op.read_eo, 0) + op.nbytes
            stats.peak_inflight_prefetch = max(
                stats.peak_inflight_prefetch, self._inflight)
            self._replayed.append(op)
        elif isinstance(op, Compute):
            # prefetches issued at earlier phases complete by their read
            # EO: retire their double-buffer slots at the phase boundary,
            # and fence optimizer slots whose read EO has arrived
            if op.eo > self._retired_eo:
                for eo in list(self._done_at):
                    if eo <= op.eo:
                        self._inflight -= self._done_at.pop(eo)
                for eo in list(self._opt_fence_at):
                    if eo <= op.eo:
                        for owner in self._opt_fence_at.pop(eo):
                            self.engine.opt_fence(owner, stats)
                self._retired_eo = op.eo
            self.env.step(op)
            self._replayed.append(op)
        elif isinstance(op, SwapOut):
            if op.tensor in store.alive:
                store.swap_out(op.tensor, stats, op.host_offset)
                self._replayed.append(op)
        elif isinstance(op, Free):
            store.free_owner(op.tensor)
            self._replayed.append(op)
        if self.sanitizer is not None:
            self.sanitizer.step(op)
            self.sanitizer.cross_check(store.alive, op_index)
            stats.sanitizer_checks += 1

    # ---------------------------------------------------------- finalise
    def _finish(self) -> None:
        t0 = time.perf_counter()
        stats, plan = self.stats, self.plan
        self.engine.drain(stats)
        if self.optim is not None:
            self.optim.finish()
        stats.wall_time_s += time.perf_counter() - t0
        stats.hbm_high_water = self.hbm.high_water
        stats.host_high_water = self.store.host_pool.high_water
        stats.replayed_ops = tuple(self._replayed)
        stats.dispatch_calls = len(self._replayed)
        self.backend._finalize_stats(stats, self.engine)
        self.backend._last_stats = stats
        self.backend._planned_inflight = self.schedule.peak_inflight_prefetch
        if plan is not None:
            stats.planned_peak = plan.activation_residency_peak()
            stats.planned_host_pool = plan.host_pool_bytes
            if stats.hbm_high_water > stats.planned_peak:
                raise AssertionError(
                    f"swap executor exceeded the planned residency peak: "
                    f"{stats.hbm_high_water} > {stats.planned_peak} bytes")
            if stats.host_high_water > stats.planned_host_pool:
                raise AssertionError(
                    f"swap executor exceeded the packed host pool: "
                    f"{stats.host_high_water} > {stats.planned_host_pool} "
                    f"bytes")
        _check_opt_high_water(plan, stats)
        self._finished = True
        self._result = (self.env.loss_val, self.env.grads, stats)
        self._release()


def _slot_layer(name: str) -> str:
    """The layer of optimizer slot ``O:<layer>``."""
    return name[len("O:"):]


class _ReplayBackend:
    """Shared interpreter: walk the compiled op list, account residency.

    Subclasses choose the :class:`TransferEngine` wired into the store;
    everything else — layer math dispatch, alias-group accounting,
    high-water assertions, replay-equality bookkeeping — is common, so the
    two backends cannot drift apart semantically.
    """

    name = "replay"

    def __init__(self, *, sanitize: bool = False):
        self.sanitize = bool(sanitize)
        self._last_stats: Optional[SwapExecStats] = None
        self._planned_inflight: Optional[int] = None

    def make_engine(self, device: torch.device) -> TransferEngine:
        raise NotImplementedError

    # ---------------------------------------------------------------- start
    def start(self, graph: LayerGraph, params, x, label, *,
              schedule: OffloadSchedule,
              ordered: Optional[OrderedTensors] = None,
              plan=None, lowered=None, mask=None,
              engine: Optional[TransferEngine] = None,
              optim=None) -> ScheduleCursor:
        """Admit a schedule and return a resumable :class:`ScheduleCursor`.

        The same verified admission as :meth:`run`, but the caller chooses
        when each phase executes (and may supply a shared ``engine``, e.g.
        a session-scoped view over one :class:`DeviceStreamEngine`, so
        several cursors' DMAs interleave on one copy stream).  The replay
        runs on ``x``'s device.  ``optim`` (an ``OffloadedStep``) must
        hold the slots the lowered optimizer ops name.
        """
        from repro_torch.core.plan import lower_schedule
        from repro_torch.core.verify import (StaticResidencyModel,
                                             is_verified, mark_verified,
                                             verify_schedule)
        if ordered is None:
            ordered = compute_execution_order(graph, int(x.shape[0]))
        if lowered is None:
            lowered = lower_schedule(ordered, schedule, plan)
        # admission check: a plan-backed schedule must have passed static
        # verification before any transfer op reaches a copy stream —
        # verify on the spot if compile-time verification was skipped
        if plan is not None and not is_verified(lowered):
            verify_schedule(ordered, schedule, plan,
                            lowered).raise_if_errors()
            mark_verified(lowered)
        sanitizer = StaticResidencyModel(ordered) if self.sanitize else None
        if engine is None:
            engine = self.make_engine(x.device)
        # the optimizer lane's host pool: the optimizer plan's packed
        # copies, wherever the lowered prefetches place them
        from repro_torch.core.plan import OptPrefetch
        opt_ops = [op for op in lowered.ops if isinstance(op, OptPrefetch)]
        if optim is not None:
            want = {(op.tensor, op.host_nbytes) for op in opt_ops}
            have = {(s.name, s.host_nbytes)
                    for s in optim.runtime.plan.slots}
            if want != have:
                raise ValueError(
                    "the optimizer step's slots are not the ones this "
                    f"schedule moves: {sorted(have ^ want)[:4]}")
            opt_pool = 0        # the step's host copies are what moves
        else:
            opt_pool = max((op.host_offset + op.host_nbytes
                            for op in opt_ops), default=0)
        engine.reserve(plan.host_pool_bytes if plan is not None else 0,
                       opt_pool)
        return ScheduleCursor(self, graph, params, x, label,
                              schedule=schedule, ordered=ordered, plan=plan,
                              lowered=lowered, mask=mask, engine=engine,
                              sanitizer=sanitizer, optim=optim)

    # ------------------------------------------------------------------ run
    def run(self, graph: LayerGraph, params, x, label, *,
            schedule: OffloadSchedule,
            ordered: Optional[OrderedTensors] = None,
            plan=None, lowered=None, mask=None,
            engine: Optional[TransferEngine] = None, optim=None):
        cursor = self.start(graph, params, x, label, schedule=schedule,
                            ordered=ordered, plan=plan, lowered=lowered,
                            mask=mask, engine=engine, optim=optim)
        while cursor.advance():
            pass
        return cursor.result()

    def _finalize_stats(self, stats: SwapExecStats,
                        engine: TransferEngine) -> None:
        pass

    # --------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        """Summary of the last :meth:`run` (transfer counts + high waters)."""
        if self._last_stats is None:
            raise RuntimeError(
                f"{type(self).__name__}.report() needs a completed run()")
        s = self._last_stats
        return {
            "backend": s.backend,
            "swap_outs": s.swap_outs,
            "prefetches": s.prefetches,
            "dma_bytes": s.dma_bytes,
            "late_swap_ins": s.late_swap_ins,
            "hbm_high_water": s.hbm_high_water,
            "host_high_water": s.host_high_water,
            "peak_inflight_prefetch": s.peak_inflight_prefetch,
            "planned_peak_inflight_prefetch": self._planned_inflight,
            "sanitizer_checks": s.sanitizer_checks,
            "dispatch_calls": s.dispatch_calls,
            "replayed_op_count": len(s.replayed_ops),
            "wall_time_s": s.wall_time_s,
            "opt_swap_outs": s.opt_swap_outs,
            "opt_prefetches": s.opt_prefetches,
            "opt_dma_bytes": s.opt_dma_bytes,
            "opt_compressed_bytes": s.opt_compressed_bytes,
            "opt_device_high_water": s.opt_device_high_water,
        }


class SimulatedBackend(_ReplayBackend):
    """Synchronous replay — the default executor backend.

    Every transfer op blocks until its bytes land, so scheduling effects
    are fully deterministic and the measured stats are bit-for-bit the
    values the planner-validation tests assert."""

    name = "sim"

    def make_engine(self, device: torch.device) -> TransferEngine:
        return SyncHostEngine(device)


class AsyncDeviceBackend(_ReplayBackend):
    """Issue the compiled transfer ops on a CUDA copy stream.

    ``SwapOut`` lowers to a non-blocking D2H copy into the owner's slot of
    one pinned host pool, dispatched (not awaited) during its scheduled
    phase; ``Prefetch`` lowers to the H2D copy issued ``prefetch_margin``
    phases ahead of the read and fenced by an event only when the
    consuming compute touches the tensor (see
    :class:`DeviceStreamEngine`).  The backend keeps its host pool across
    runs, so a training loop pins it once.  For CPU tensors the same
    engine runs with plain copies, for its accounting.  ``report()``
    carries the achieved overlap."""

    name = "async"

    def __init__(self, device=None, *, sanitize: bool = False):
        super().__init__(sanitize=sanitize)
        self.device = device
        self._pool: Optional[HostPool] = None
        self._opt_pool: Optional[HostPool] = None

    def make_engine(self, device: torch.device) -> TransferEngine:
        dev = torch.device(self.device) if self.device is not None \
            else device
        if self._pool is None or self._pool.device != dev:
            self._pool = HostPool(dev)
            self._opt_pool = HostPool(dev)
        return DeviceStreamEngine(dev, pool=self._pool,
                                  opt_pool=self._opt_pool)

    def _finalize_stats(self, stats: SwapExecStats,
                        engine: TransferEngine) -> None:
        # fences/stalled_fences accumulate per call on the stats record
        # (so a session-scoped view over a shared engine still yields
        # per-session numbers); the engine contributes its in-flight
        # high-water marks
        stats.inflight_high_water = getattr(engine, "inflight_high_water", 0)
        stats.opt_inflight_high_water = getattr(
            engine, "opt_inflight_high_water", 0)
        stats.achieved_overlap = (
            (stats.fences - stats.stalled_fences) / stats.fences
            if stats.fences else None)

    def report(self) -> Dict[str, Any]:
        out = super().report()
        s = self._last_stats
        planned = self._planned_inflight
        out.update({
            "inflight_high_water": s.inflight_high_water,
            "fences": s.fences,
            "stalled_fences": s.stalled_fences,
            "achieved_overlap": s.achieved_overlap,
            # measured double-buffer occupancy vs what the plan budgeted —
            # <= 1.0 means the stream never held more than planned
            "inflight_vs_planned": (s.inflight_high_water / planned
                                    if planned else None),
            # measured bus-time split: seconds the activation DMAs ran
            # hidden under dispatched compute vs seconds consumer fences
            # actually stalled the compute stream — and the same split for
            # the optimizer lane
            "hidden_dma_s": s.hidden_dma_s,
            "exposed_dma_s": s.exposed_dma_s,
            "opt_hidden_dma_s": s.opt_hidden_dma_s,
            "opt_exposed_dma_s": s.opt_exposed_dma_s,
            "opt_fences": s.opt_fences,
            "opt_stalled_fences": s.opt_stalled_fences,
            "opt_inflight_high_water": s.opt_inflight_high_water,
            "cross_hidden_dma_s": s.cross_hidden_dma_s,
        })
        return out


class _NotPorted:
    """A registry entry for a backend the port does not have yet."""

    def __init__(self, name: str, why: str):
        self.name, self.why = name, why

    def __call__(self):
        raise NotImplementedError(
            f"executor backend {self.name!r} is not ported yet: {self.why}")


# Registry: MemoryPlanConfig.executor values -> backend factories.
BACKENDS = {
    SimulatedBackend.name: SimulatedBackend,
    AsyncDeviceBackend.name: AsyncDeviceBackend,
    "jit_blocks": _NotPorted(
        "jit_blocks", "its counterpart replays each proven FusedBlock as "
        "one CUDA-graph replay over the plan's packed device arena, the "
        "next item of ROADMAP queue A"),
}


def get_backend(executor: Union[str, ExecutorBackend, None]
                ) -> ExecutorBackend:
    """Resolve an executor selection to a backend instance.

    ``None`` means the default (``"sim"``); a string is looked up in
    :data:`BACKENDS` (unknown names raise with the valid options; a name
    not ported yet raises ``NotImplementedError``); an
    :class:`ExecutorBackend` instance passes through untouched, the hook
    for custom backends."""
    if executor is None:
        executor = SimulatedBackend.name
    if isinstance(executor, str):
        cls = BACKENDS.get(executor)
        if cls is None:
            raise ValueError(
                f"unknown executor backend {executor!r}; "
                f"valid: {sorted(BACKENDS)}")
        return cls()
    if isinstance(executor, ExecutorBackend):
        return executor
    raise TypeError(
        f"executor must be a backend name {sorted(BACKENDS)} or an "
        f"ExecutorBackend instance, got {type(executor).__name__}")


def swap_planned_loss_and_grads(
    graph: LayerGraph,
    params: Dict[str, Dict[str, Tensor]],
    x: Tensor, label: Tensor, *,
    schedule: OffloadSchedule,
    ordered: Optional[OrderedTensors] = None,
    plan: Optional["SwapAwarePlan"] = None,  # noqa: F821
    lowered: Optional["ExecutionSchedule"] = None,  # noqa: F821
    executor: Union[str, ExecutorBackend, None] = None,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Dict[str, Tensor]], SwapExecStats]:
    """One layer-basis iteration replaying the compiled op list.

    Identical numerics to
    :func:`repro_torch.core.exec.layers.planned_loss_and_grads` (tensors
    round-trip through the host exactly), but walks the lowered
    :class:`repro_torch.core.plan.ExecutionSchedule` directly: every
    ``Compute``, ``SwapOut``, ``Prefetch`` and ``Free`` was decided at
    compile time, so the executor holds no scheduling policy — it replays
    ops and accounts HBM / host-pool residency high-water marks.  When no
    ``lowered`` schedule is supplied (hand-wired callers) it is derived
    here from ``schedule``/``plan``.  With a :class:`SwapAwarePlan`,
    asserts the measured high-water marks never exceed the planned
    residency peak and the packed host pool.  ``executor`` picks the
    backend ("sim" default, "async" for the copy stream) — see
    :func:`get_backend`.
    """
    return get_backend(executor).run(
        graph, params, x, label, schedule=schedule, ordered=ordered,
        plan=plan, lowered=lowered, mask=mask)
