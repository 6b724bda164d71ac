"""Pluggable executor backends replaying the lowered ExecutionSchedule.

One interpreter, three backends:

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

* :class:`JitBlocksBackend` (``"jit_blocks"``) — the async transfers
  plus fused compute dispatch: the static dependence prover
  (:mod:`repro_torch.core.verify.deps`) partitions the op list into
  fusion-legal ``Compute`` runs, and each run replays as ONE dispatch —
  on the card one ``torch.cuda.CUDAGraph`` replay, captured once, over the
  plan's packed device arena (:class:`repro_torch.core.exec.store.DeviceArena`),
  where every activation sits at its planned offset and so at one address
  in every step; on the CPU one call of the interpreter per block.

Optimizer-state transfers (``OptPrefetch`` / ``OptSwapOut``, from
``MemoryPlanConfig(optim_offload=True)``) are replayed by every backend
(never fused):
each prefetch is issued to the engine's optimizer lane at its EO and
fenced at the first ``Compute`` of its read EO, and the working region's
residency is held to the packed optimizer plan.  A replay given an
:class:`repro_torch.core.optim_offload.OffloadedStep` (``optim=``)
updates the optimizer state at those ops: the prefetch moves the slot's
host copy, and at ``OptSwapOut``, once the layer's grads are final, the
step runs the AdamW update and sends the new state back.  Without one
the lane moves the planned bytes and updates nothing.

``sim`` and ``async`` replay the compiled op list *verbatim*:
``SwapExecStats.replayed_ops == lowered.ops`` is gated per backend, so a
backend cannot silently skip or reorder a planned transfer.  ``jit_blocks``
replays a *proven-equivalent permutation* instead (each block's frees
deferred to its end): the same op multiset, admitted only after
:func:`repro_torch.core.verify.schedules_equivalent` signs off on it.

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

import dataclasses
import time
import warnings
import weakref
from typing import (Any, Callable, Dict, List, Optional, Protocol, Tuple,
                    Union, runtime_checkable)

import torch

from repro_torch.core import inplace
from repro_torch.core.exec.layers import (_needs_deriv, _param_owner,
                                          layer_calc_derivative,
                                          layer_calc_gradient, layer_forward,
                                          loss_derivative, loss_forward)
from repro_torch.core.exec.store import (ActivationStore,
                                         ArenaActivationStore, DeviceArena,
                                         DeviceStreamEngine, HbmTracker,
                                         HostPool, SwapExecStats,
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
                 aliased: Callable[[str, str], bool],
                 grad_bufs: Optional[Dict[str, Dict[str, Tensor]]] = None):
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
        # (``grad_bufs``: the caller's, already zeroed)
        self._grad_bufs = grad_bufs if grad_bufs is not None \
            else _zero_grads(graph, params)
        self._grad_owners: List[str] = []
        self.loss_val = None

    @property
    def grads(self) -> Dict[str, Dict[str, Tensor]]:
        """The gradients of every owner a CG phase reached."""
        return {o: self._grad_bufs[o] for o in self._grad_owners}

    def state(self) -> Dict[str, Any]:
        """The backward state a phase reads and writes, in containers of
        its own (the tensors are shared)."""
        return {"ctxs": dict(self.ctxs), "derivs": dict(self.derivs),
                "pending_dxs": {k: list(v)
                                for k, v in self.pending_dxs.items()},
                "pending_cd": dict(self.pending_cd),
                "grad_owners": list(self._grad_owners),
                "loss": self.loss_val}

    def load(self, state: Dict[str, Any]) -> None:
        """Take ``state`` as the backward state; its ``ctxs`` may hold some
        layers' only, and are merged into the saved contexts."""
        self.ctxs.update(state["ctxs"])
        self.derivs = dict(state["derivs"])
        self.pending_dxs = {k: list(v)
                            for k, v in state["pending_dxs"].items()}
        self.pending_cd = dict(state["pending_cd"])
        self._grad_owners = list(state["grad_owners"])
        self.loss_val = state["loss"]

    def read_names(self, op) -> List[str]:
        """Activation names this Compute may read — the consumer-fence set
        (its layer inputs plus its own output, which backward ctxs
        reference)."""
        return list(self.graph.layer(op.layer).inputs) + [op.layer]

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


def _trainable_owners(graph: LayerGraph) -> List[str]:
    return sorted({_param_owner(graph, l) for l in graph.layers
                   if l.trainable and l.weight_shapes()})


def _zero_grads(graph: LayerGraph, params) -> Dict[str, Dict[str, Tensor]]:
    return {owner: {k: torch.zeros_like(w) for k, w in params[owner].items()}
            for owner in _trainable_owners(graph)}


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
                 engine: TransferEngine, sanitizer, optim=None,
                 store: Optional[ActivationStore] = None, grad_bufs=None):
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
        if store is None:
            store = ActivationStore(ordered, HbmTracker(), engine=engine)
        self.store = store
        self.hbm = store.hbm
        store.device["__input__"] = x

        def aliased(a: str, b: str) -> bool:
            owner = store.owner_of(a)
            return owner is not None and owner == store.owner_of(b)

        self.env = _ComputeEnv(graph, params, label, mask,
                               get=self.fenced_get, put=store.put,
                               aliased=aliased, grad_bufs=grad_bufs)
        self._replayed: List[Any] = []
        # replayed ops that took no dispatch of their own (fused blocks)
        self.fused_away = 0
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

    def fenced_get(self, name: str) -> Tensor:
        return self.store.get(name, self.stats)

    # ----------------------------------------------------------- op body
    def _retire(self, eo: int) -> None:
        """Prefetches issued at earlier phases complete by their read EO:
        retire their double-buffer slots at the phase boundary, and fence
        the optimizer slots whose read EO has arrived."""
        if eo <= self._retired_eo:
            return
        for e in list(self._done_at):
            if e <= eo:
                self._inflight -= self._done_at.pop(e)
        for e in list(self._opt_fence_at):
            if e <= eo:
                for owner in self._opt_fence_at.pop(e):
                    self.engine.opt_fence(owner, self.stats)
        self._retired_eo = eo

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
            self._retire(op.eo)
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
        stats.dispatch_calls = len(self._replayed) - self.fused_away
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
        ordered, lowered = self._admit(graph, x, schedule, ordered, plan,
                                       lowered)
        sanitizer = self._sanitizer(ordered)
        engine = self._engine_for(x, plan, lowered, engine, optim)
        return ScheduleCursor(self, graph, params, x, label,
                              schedule=schedule, ordered=ordered, plan=plan,
                              lowered=lowered, mask=mask, engine=engine,
                              sanitizer=sanitizer, optim=optim)

    def _admit(self, graph: LayerGraph, x, schedule: OffloadSchedule,
               ordered: Optional[OrderedTensors], plan, lowered):
        """``(ordered, lowered)``, derived where not given, after the
        admission check: a plan-backed schedule must have passed static
        verification before any transfer op reaches a copy stream —
        verified on the spot if compile-time verification was skipped."""
        from repro_torch.core.plan import lower_schedule
        from repro_torch.core.verify import (is_verified, mark_verified,
                                             verify_schedule)
        if ordered is None:
            ordered = compute_execution_order(graph, int(x.shape[0]))
        if lowered is None:
            lowered = lower_schedule(ordered, schedule, plan)
        if plan is not None and not is_verified(lowered):
            verify_schedule(ordered, schedule, plan,
                            lowered).raise_if_errors()
            mark_verified(lowered)
        return ordered, lowered

    def _sanitizer(self, ordered: OrderedTensors):
        from repro_torch.core.verify import StaticResidencyModel
        return StaticResidencyModel(ordered) if self.sanitize else None

    def _engine_for(self, x, plan, lowered, engine: Optional[TransferEngine],
                    optim) -> TransferEngine:
        """The replay's engine (``engine``, else the backend's own), its
        host pools reserved for the plan."""
        from repro_torch.core.plan import OptPrefetch
        if engine is None:
            engine = self.make_engine(x.device)
        # the optimizer lane's host pool: the optimizer plan's packed
        # copies, wherever the lowered prefetches place them
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
        return engine

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


# ---------------------------------------------------------------------------
# jit_blocks: each proven FusedBlock as one CUDA-graph replay over the arena
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Slot:
    """Skeleton placeholder for one tensor leaf of a flattened state."""

    index: int


def _flatten_state(obj, leaves: List[Tensor]):
    """Split an interpreter state into (skeleton, tensor leaves): saved
    contexts mix tensors with strings, shapes and ``("@act", name)``
    references, so tensors are the leaves and everything else is
    skeleton, which compares with ``==``."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _Slot(len(leaves) - 1)
    if isinstance(obj, dict):
        return {k: _flatten_state(v, leaves) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_flatten_state(v, leaves) for v in obj)
    if isinstance(obj, list):
        return [_flatten_state(v, leaves) for v in obj]
    return obj


def _unflatten_state(skel, leaves: List[Tensor]):
    if isinstance(skel, _Slot):
        return leaves[skel.index]
    if isinstance(skel, dict):
        return {k: _unflatten_state(v, leaves) for k, v in skel.items()}
    if isinstance(skel, tuple):
        return tuple(_unflatten_state(v, leaves) for v in skel)
    if isinstance(skel, list):
        return [_unflatten_state(v, leaves) for v in skel]
    return skel


def _alias(desc) -> Tensor:
    """A tensor over memory it does not own: a block graph's output in the
    chain's private pool, which every replay rewrites in capture order.
    Holding the capture's own tensor instead would keep each block's
    outputs allocated for good, and the pool would grow to their sum."""
    ptr, nbytes, device, dtype, offset, shape, stride = desc
    st = torch._C._construct_storage_from_data_pointer(ptr, device, nbytes)
    return torch.empty(0, dtype=dtype, device=device).set_(
        st, offset, shape, stride)


def _tensor_key(t: Optional[Tensor]):
    if t is None:
        return None
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)


class _LazyClones(dict):
    """Gradient buffers for a warm-up: each owner's cloned at first use,
    so the warm-up's accumulation lands in copies."""

    def __init__(self, src):
        super().__init__()
        self.src = src

    def __missing__(self, owner):
        out = self[owner] = {k: t.clone() for k, t in self.src[owner].items()}
        return out


@dataclasses.dataclass
class _Captured:
    """One block captured as a CUDA graph, and how to replay it: the
    interpreter state it was captured from (skeleton and each tensor
    leaf's address), the static copies it reads in place of leaves an
    eager op makes anew every step, the state it leaves (each output leaf
    an input passed through or an alias of the memory it was written to)
    and the arena puts to redo in the store's books."""

    graph: Any
    in_skel: Any
    in_ptrs: Tuple[int, ...]
    statics: Dict[int, Tensor]
    out_skel: Any
    outs: Tuple[Any, ...]
    puts: Tuple[Tuple[str, Any, int], ...]


class _Chain:
    """The blocks of one lowered schedule captured over one private pool,
    in replay order, and the addresses they were captured against.

    Blocks share the pool: each capture may reuse memory whose tensors the
    earlier blocks' consumers have dropped, which is sound only while the
    graphs replay in the order they were captured, one at a time.  So the
    chain is keyed as a whole, by the addresses of every tensor a block
    may read in place (the arena, the run's inputs, the parameters and the
    gradient buffers), and captured again from its first block when any
    of them moved."""

    def __init__(self, key, storages):
        self.key = key
        self.pool = torch.cuda.graph_pool_handle()
        self.blocks: Dict[int, _Captured] = {}
        # storages a block reads in place: the key's, static copies, and
        # the outputs of the blocks captured before it
        self.baked = set(storages)


@dataclasses.dataclass
class _Admitted:
    """A lowered schedule this backend admitted (under one EO analysis,
    plan and arena plan): its proven fusion plan, where each ``X:`` owner
    lives in the arena, and its captured chains by ``mask is None``."""

    ref: Any                        # weak reference to the schedule
    key: Tuple[int, int, int]       # ids of ordered, plan and arena plan
    fusion: Any
    block_at: Dict[int, Any]
    covered: frozenset
    offsets: Dict[str, Tuple[int, int]]
    arena_bytes: int
    chains: Dict[bool, _Chain] = dataclasses.field(default_factory=dict)


class JitBlocksBackend(AsyncDeviceBackend):
    """Replay each proven-fusable ``Compute`` run as one dispatch: one
    CUDA-graph replay on the card, over the plan's packed device arena.

    Per-op Python dispatch is the replay's cost on large graphs.  The
    static dependence prover (:mod:`repro_torch.core.verify.deps`) plans
    the blocks — maximal ``Compute`` runs crossing no transfer fence, no
    ``Free``-reuse hazard and no in-place re-admission — and admission is
    prove-then-run: beyond the base verifier gate, the fusion plan must
    pass :func:`verify_fusion` and the fused replay stream must pass
    :func:`schedules_equivalent` against the verified original, before
    any op runs.  Transfers, ``Free``s, the optimizer lane and the
    computes outside blocks stay eager at their issue points; at a
    block's entry its consumer fences are taken for the device-resident
    names it reads; the sanitizer cross-checks residency at block
    boundaries.

    Every ``X:`` owner group lives in one :class:`DeviceArena` of the
    plan's packed bytes at its planned offsets (:class:`ArenaActivationStore`),
    so an activation has one address in every step.  On the card each
    block is captured once as a ``torch.cuda.CUDAGraph`` — after one
    warm-up run on the capture stream, whose writes land in copies — and
    replayed on every later step; all blocks of a schedule share one
    private pool (:class:`_Chain`).  The interpreter's Python state after
    a replay points at the graph's outputs.  A capture that fails raises,
    naming the block and the op: no block of the card ever runs eagerly
    in place of its graph.  On the CPU each block runs as one call of the
    same interpreter, with no capture.

    The arena, the gradient buffers (zeroed each step) and the graphs are
    kept across runs: the returned grads are those buffers, rewritten by
    the next run (clone them to keep them); the loss is a copy.
    ``arena_plan`` is the device plan whose offsets hold the activations
    (``plan`` when not given: a swap-free plan reaches the backend as
    ``arena_plan`` alone).

    ``start`` is the async backend's admitted, phase-by-phase cursor, as
    the reference's ``JitBlocksBackend`` inherits it: a cursor replays op
    by op through the copy-stream engine and the default activation store,
    with no arena, no fusion admission and no graph, so
    ``StepScheduler(backend=JitBlocksBackend())`` serves.
    """

    name = "jit_blocks"

    def __init__(self, device=None, *, sanitize: bool = False):
        super().__init__(device, sanitize=sanitize)
        self._arena_buf: Optional[DeviceArena] = None
        self._grad_bufs: Optional[Tuple[Any, Dict]] = None
        self._mask_buf: Optional[Tensor] = None
        self._side = None
        # id(lowered schedule) -> its admission; dropped, graphs and pools
        # with it, once the schedule is gone (the verifier's registry keys
        # schedules the same way)
        self._admitted: Dict[int, _Admitted] = {}
        self._last_fusion = None

    # -------------------------------------------------------------- set-up
    def _admit_fused(self, lowered, ordered: OrderedTensors, plan,
                     arena_plan) -> _Admitted:
        """Fusion admission, once per schedule: plan the blocks, re-prove
        them legal, prove the fused replay stream keeps every dependence
        edge of the verified original — only then may a block dispatch —
        and place every ``X:`` owner at its planned arena offsets."""
        from repro_torch.core.plan import SwapOut, planned_device_offset
        from repro_torch.core.verify import (ScheduleVerificationError,
                                             plan_fusion, replay_stream,
                                             schedules_equivalent,
                                             verify_fusion)
        key = (id(ordered), id(plan), id(arena_plan))
        entry = self._admitted.get(id(lowered))
        if entry is not None and entry.ref() is lowered and entry.key == key:
            return entry
        for k in [k for k, e in self._admitted.items() if e.ref() is None]:
            del self._admitted[k]
        fusion = plan_fusion(lowered, ordered, plan)
        errors = tuple(d for d in verify_fusion(fusion, lowered, ordered,
                                                plan)
                       if d.severity == "error")
        if errors:
            raise ScheduleVerificationError(errors)
        schedules_equivalent(lowered, replay_stream(lowered, fusion),
                             ordered=ordered, plan=plan).raise_if_errors()
        if arena_plan is None:
            raise ValueError(
                "jit_blocks holds every activation at its planned arena "
                "offset: it needs the plan (a schedule lowered without one "
                "places nothing)")
        swapped = {op.tensor for op in lowered.ops if isinstance(op, SwapOut)}
        offsets: Dict[str, Tuple[int, int]] = {}
        for t in ordered.planned_tensors():
            if not t.name.startswith("X:"):
                continue
            pre = planned_device_offset(arena_plan, t.name, post=False)
            post = planned_device_offset(arena_plan, t.name, post=True)
            if pre < 0:
                raise ValueError(f"{t.name} has no arena offset in the plan")
            if t.name not in swapped and post != pre:
                raise ValueError(
                    f"{t.name} moves from arena offset {pre} to {post} "
                    f"with no transfer to carry it")
            offsets[t.name] = (pre, post)
        entry = self._admitted[id(lowered)] = _Admitted(
            ref=weakref.ref(lowered), key=key, fusion=fusion,
            block_at={min(b.op_indices): b for b in fusion.blocks},
            covered=frozenset(i for b in fusion.blocks
                              for i in b.op_indices),
            offsets=offsets, arena_bytes=arena_plan.arena_bytes)
        return entry

    @property
    def arena(self) -> Optional[DeviceArena]:
        """The device arena the last run held its activations in."""
        return self._arena_buf

    def _arena_for(self, nbytes: int, device: torch.device) -> DeviceArena:
        """The arena, kept while its size and device hold."""
        if self._arena_buf is None or self._arena_buf.device != device \
                or self._arena_buf.nbytes != nbytes:
            self._arena_buf = None          # release the old arena first
            self._arena_buf = DeviceArena(device, nbytes)
        return self._arena_buf

    def _grads_for(self, graph: LayerGraph, params):
        """The gradient buffers, allocated once per parameter layout and
        zeroed for this step."""
        owners = _trainable_owners(graph)
        sig = tuple((o, k, tuple(w.shape), w.dtype, w.device)
                    for o in owners for k, w in sorted(params[o].items()))
        if self._grad_bufs is None or self._grad_bufs[0] != sig:
            self._grad_bufs = (sig, _zero_grads(graph, params))
        else:
            for entry in self._grad_bufs[1].values():
                for g in entry.values():
                    g.zero_()
        return self._grad_bufs[1]

    def _mask_for(self, mask, label: Tensor):
        """The mask as the loss reads it (the label's float dtype, on its
        device), so no conversion runs inside a block; a mask that needs
        one is copied into a buffer of the backend's, whose address holds
        across steps."""
        if mask is None:
            return None
        dtype = label.dtype if label.is_floating_point() else torch.float32
        if isinstance(mask, torch.Tensor) and mask.dtype == dtype \
                and mask.device == label.device:
            return mask
        m = torch.as_tensor(mask, dtype=dtype)
        if self._mask_buf is None or self._mask_buf.shape != m.shape \
                or self._mask_buf.device != label.device:
            self._mask_buf = torch.empty(m.shape, dtype=dtype,
                                         device=label.device)
        self._mask_buf.copy_(m)
        return self._mask_buf

    # ----------------------------------------------------------------- run
    def run(self, graph: LayerGraph, params, x, label, *,
            schedule: OffloadSchedule,
            ordered: Optional[OrderedTensors] = None,
            plan=None, lowered=None, mask=None,
            engine: Optional[TransferEngine] = None, optim=None,
            arena_plan=None):
        from repro_torch.core.verify import (ScheduleVerificationError,
                                             plan_fusion, replay_stream,
                                             schedules_equivalent,
                                             verify_fusion)
        if engine is not None:
            raise ValueError(
                "jit_blocks runs its own copy-stream engine over its arena; "
                "an injected engine runs on 'sim' or 'async'")
        t0 = time.perf_counter()
        ordered, lowered = self._admit(graph, x, schedule, ordered, plan,
                                       lowered)
        admitted = self._admit_fused(
            lowered, ordered, plan,
            arena_plan if arena_plan is not None else plan)
        self._last_fusion = admitted.fusion
        engine = self._engine_for(x, plan, lowered, None, optim)
        arena = self._arena_for(admitted.arena_bytes, x.device)
        grads = self._grads_for(graph, params)
        mask = self._mask_for(mask, label)
        store = ArenaActivationStore(ordered, HbmTracker(), arena,
                                     admitted.offsets, engine)
        cursor = ScheduleCursor(
            self, graph, params, x, label, schedule=schedule,
            ordered=ordered, plan=plan, lowered=lowered, mask=mask,
            engine=engine, sanitizer=self._sanitizer(ordered), optim=optim,
            store=store, grad_bufs=grads)
        chain = None
        if arena.cuda:
            chain = self._chain_for(admitted, arena, params, x, label, mask,
                                    grads)
        stats = cursor.stats
        ops = lowered.ops
        block_at, covered = admitted.block_at, admitted.covered
        phase_eo = None
        try:
            for op_index, op in enumerate(ops):
                block = block_at.get(op_index)
                if block is not None:
                    engine.begin_phase()
                    phase_eo = None
                    cursor._retire(ops[block.compute_indices[-1]].eo)
                    self._exec_block(block, ops, cursor, chain)
                    cursor.fused_away += len(block.op_indices) - 1
                    self._replay_block_books(block, ops, cursor)
                elif op_index not in covered:
                    if op.eo != phase_eo:
                        engine.begin_phase()
                        phase_eo = op.eo
                    cursor._exec_op(op, op_index)
            stats.wall_time_s = time.perf_counter() - t0
            stats.arena_copy_bytes = store.copy_bytes
            cursor._finish()            # the card is done after its drain
            stats.arena_write_wait_s = arena.settle()
        except BaseException:
            # a step that failed leaves no chain half captured, and nothing
            # of it still running on the arena's bytes
            if chain is not None:
                admitted.chains.pop(mask is None, None)
            if arena.cuda:
                torch.cuda.synchronize(arena.device)
            arena.settle()
            raise
        loss, grads_out, stats = cursor.result()
        return (loss.clone() if loss is not None else None), grads_out, stats

    def _replay_block_books(self, block, ops, cursor: ScheduleCursor) -> None:
        """A block's ops into the replayed stream, its deferred frees, and
        the sanitizer's steps: one cross-check at the block's end."""
        store, sanitizer = cursor.store, cursor.sanitizer
        for ci in block.compute_indices:
            cursor._replayed.append(ops[ci])
            if sanitizer is not None:
                sanitizer.step(ops[ci])
                cursor.stats.sanitizer_checks += 1
        for fi in block.free_indices:
            store.free_owner(ops[fi].tensor)
            cursor._replayed.append(ops[fi])
            if sanitizer is not None:
                sanitizer.step(ops[fi])
                cursor.stats.sanitizer_checks += 1
        if sanitizer is not None:
            last = max(block.free_indices or block.compute_indices)
            sanitizer.cross_check(store.alive, last)

    def _chain_for(self, admitted: _Admitted, arena: DeviceArena, params,
                   x, label, mask, grads) -> _Chain:
        fixed = [arena.buf, x, label] + ([mask] if mask is not None else [])
        fixed += [w for o in sorted(params) for _, w in sorted(
            params[o].items())]
        fixed += [g for o in sorted(grads) for _, g in sorted(
            grads[o].items())]
        key = tuple(_tensor_key(t) for t in fixed)
        chains = admitted.chains
        chain = chains.get(mask is None)
        if chain is None or chain.key != key:
            chain = chains[mask is None] = _Chain(
                key, (t.untyped_storage().data_ptr() for t in fixed))
        return chain

    # --------------------------------------------------------------- block
    def _exec_block(self, block, ops, cursor: ScheduleCursor,
                    chain: Optional[_Chain]) -> None:
        """Fence the block's inputs, order its arena writes after the
        swap-outs still reading those bytes, then run it as one dispatch."""
        env, store, stats = cursor.env, cursor.store, cursor.stats
        computes = [ops[ci] for ci in block.compute_indices]
        # consumer fences for the device-resident names the block reads:
        # read_names over-approximates (a CG lists every input even when
        # its planned read is later), and fencing a host-resident name
        # would swap it in ahead of its Prefetch; the verifier proved every
        # name a block compute reads resident before the block
        for op in computes:
            for name in env.read_names(op):
                if name in store.device:
                    store.get(name, stats)
        for op in computes:
            owner = store.owner_of(op.layer) if op.kind == "F" else None
            if owner is not None and owner not in store.alive:
                store.arena.before_write(*store.region_of(owner))

        def resident(name: str) -> Tensor:
            try:
                return store.device[name]
            except KeyError:
                raise KeyError(
                    f"block {block.index} reads {name!r}, which is not "
                    f"resident at its entry") from None

        env.get = resident
        try:
            if chain is None:
                for op in computes:
                    env.step(op)
            else:
                self._graph_block(chain, block, computes, cursor)
        finally:
            env.get = cursor.fenced_get

    def _state(self, cursor: ScheduleCursor, computes):
        """The interpreter state a block reads and leaves: the saved
        contexts of its own layers (the only ones its phases read or
        write), the backward state, and the store's entries that hold no
        arena bytes (the input, views of it)."""
        state = cursor.env.state()
        ctxs = state["ctxs"]
        state["ctxs"] = {op.layer: ctxs[op.layer] for op in computes
                         if op.layer in ctxs}
        store = cursor.store
        state["device"] = {n: t for n, t in store.device.items()
                           if store.owner_of(n) is None}
        return state

    def _graph_block(self, chain: _Chain, block, computes,
                     cursor: ScheduleCursor) -> None:
        env, store, stats = cursor.env, cursor.store, cursor.stats
        leaves: List[Tensor] = []
        skel = _flatten_state(self._state(cursor, computes), leaves)
        entry = chain.blocks.get(block.index)
        if entry is None:
            entry = self._capture(chain, block, computes, cursor, skel,
                                  leaves)
            chain.blocks[block.index] = entry
            stats.graph_captures += 1
            entry.graph.replay()
            stats.graph_replays += 1
            return
        if entry.in_skel != skel:
            raise RuntimeError(
                f"jit_blocks: the interpreter state entering block "
                f"{block.index} differs from the one it was captured from")
        seen = list(leaves)
        for i, leaf in enumerate(leaves):
            static = entry.statics.get(i)
            if static is not None:
                if leaf.data_ptr() != static.data_ptr():
                    static.copy_(leaf)
                seen[i] = static
            elif leaf.data_ptr() != entry.in_ptrs[i]:
                raise RuntimeError(
                    f"jit_blocks: block {block.index} would replay over a "
                    f"stale address: an input it reads in place moved")
        entry.graph.replay()
        stats.graph_replays += 1
        for put in entry.puts:
            store.replay_put(*put)
        out = _unflatten_state(entry.out_skel, [
            seen[d[1]] if d[0] == "in" else _alias(d[1])
            for d in entry.outs])
        store.device.update(out.pop("device"))
        env.load(out)

    def _capture(self, chain: _Chain, block, computes,
                 cursor: ScheduleCursor, skel, leaves) -> _Captured:
        """Warm the block up on the capture stream, capture it into the
        chain's pool and record how to replay it.  Leaves the interpreter
        and the store as the block leaves them (the data lands when the
        caller replays the graph)."""
        env, store = cursor.env, cursor.store
        device = store.arena.device
        if self._side is None or self._side.device != device:
            self._side = torch.cuda.Stream(device)
        side, compute = self._side, torch.cuda.current_stream(device)
        # a leaf an eager op made is new every step: the graph reads a
        # static copy of it, refreshed before each replay
        statics: Dict[int, Tensor] = {}
        seen = list(leaves)
        for i, leaf in enumerate(leaves):
            if leaf.untyped_storage().data_ptr() not in chain.baked:
                statics[i] = seen[i] = leaf.clone()
                chain.baked.add(seen[i].untyped_storage().data_ptr())
        state = _unflatten_state(skel, seen)
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            self._warm_up(env, store, computes, state)
        compute.wait_stream(side)

        env.load(state)
        store.device.update(state["device"])
        graph = torch.cuda.CUDAGraph()
        store.log = []
        at, err = None, None
        with torch.cuda.stream(side):
            graph.capture_begin(pool=chain.pool)
            try:
                for at in computes:
                    env.step(at)
            except Exception as e:          # noqa: BLE001 - re-raised below
                err = e
            finally:
                try:
                    with warnings.catch_warnings():
                        # a block of views and pass-through derivatives
                        # launches no kernel: its graph is empty, and
                        # replaying it is a no-op, not a misplaced capture
                        warnings.filterwarnings(
                            "ignore", message="The CUDA Graph is empty")
                        graph.capture_end()
                except Exception as e:      # noqa: BLE001 - re-raised below
                    err = err or e
        puts, store.log = tuple(store.log), None
        if err is not None:
            kind = cursor.graph.layer(at.layer).kind if at else None
            raise RuntimeError(
                f"jit_blocks: block {block.index} failed to capture as a "
                f"CUDA graph at {at} ({kind} layer): {err}") from err
        compute.wait_stream(side)

        out_leaves: List[Tensor] = []
        out_skel = _flatten_state(self._state(cursor, computes), out_leaves)
        ids = {id(t): i for i, t in enumerate(seen)}
        outs = []
        for t in out_leaves:
            if id(t) in ids:
                outs.append(("in", ids[id(t)]))
                continue
            st = t.untyped_storage()
            outs.append(("alias", (st.data_ptr(), st.nbytes(), t.device,
                                   t.dtype, t.storage_offset(),
                                   tuple(t.shape), tuple(t.stride()))))
            chain.baked.add(st.data_ptr())
        return _Captured(graph=graph, in_skel=skel,
                         in_ptrs=tuple(t.data_ptr() for t in leaves),
                         statics=statics, out_skel=out_skel,
                         outs=tuple(outs), puts=puts)

    @staticmethod
    def _warm_up(env: _ComputeEnv, store: ArenaActivationStore, computes,
                 state) -> None:
        """Run the block once eagerly on copies (torch's CUDA-graph notes
        prescribe a warm-up on the capture stream: lazy handles and
        workspaces are made outside the capture), leaving the arena and
        the gradient buffers untouched."""
        scratch: Dict[str, Tensor] = {}

        def get(name: str) -> Tensor:
            if name not in scratch:
                scratch[name] = store.device[name].clone()
            return scratch[name]

        warm = _ComputeEnv(env.graph, env.params, env.label, env.mask,
                           get=get, put=scratch.__setitem__,
                           aliased=env.aliased,
                           grad_bufs=_LazyClones(env._grad_bufs))
        warm.load(state)
        for op in computes:
            warm.step(op)

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes the allocator holds in the private pools of this
        backend's captured blocks (segments of ``memory_snapshot``); None
        on the CPU or when the snapshot does not name segments' pools."""
        pools = {tuple(c.pool) for a in self._admitted.values()
                 for c in a.chains.values()}
        if not pools:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pid = seg.get("segment_pool_id")
            if pid is None:
                continue
            named = True
            if tuple(pid) in pools:
                total += seg["total_size"]
        return total if named else None

    def report(self) -> Dict[str, Any]:
        out = super().report()
        s = self._last_stats
        out.update({
            "fusion": self._last_fusion.summary(),
            "graph_captures": s.graph_captures,
            "graph_replays": s.graph_replays,
            "arena_bytes": self._arena_buf.nbytes if self._arena_buf
            else 0,
            "arena_copy_bytes": s.arena_copy_bytes,
            "arena_write_wait_s": s.arena_write_wait_s,
        })
        return out


# Registry: MemoryPlanConfig.executor values -> backend factories.
BACKENDS = {
    SimulatedBackend.name: SimulatedBackend,
    AsyncDeviceBackend.name: AsyncDeviceBackend,
    JitBlocksBackend.name: JitBlocksBackend,
}


def get_backend(executor: Union[str, ExecutorBackend, None]
                ) -> ExecutorBackend:
    """Resolve an executor selection to a backend instance.

    ``None`` means the default (``"sim"``); a string is looked up in
    :data:`BACKENDS` (unknown names raise with the valid options); an
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
