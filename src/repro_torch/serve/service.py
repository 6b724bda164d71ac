"""The serving request loop: admission, interleaved execution, rejection.

Port of ``repro/serve/service.py``. ``PersonalizationService`` is the
tenant-facing surface. One call does everything: ``submit(user, x, y,
qos=...)`` enqueues a fine-tune request, drains the queue synchronously,
and returns that request's :class:`StepResult` — status ``ok`` with the
loss and QoS numbers, or ``rejected``/``killed`` with a reason string,
never an exception for traffic-shaped failures (oversize batch, full class,
unpackable budget). Benchmark drivers use ``enqueue``/``drain`` directly to
build queue depth.

Draining is *phase-interleaved* by default (``interleave=True``): each
drain wave takes one pending request per user, admits them, and hands the
admitted sessions to :class:`repro_torch.serve.scheduler.StepScheduler`,
which round-robins their schedule cursors at phase boundaries through one
shared :class:`~repro_torch.core.exec.DeviceStreamEngine` (one CUDA copy
stream) — session A's DMA hides under session B's compute (the measured
``cross_hidden_dma_s``).  Same-user requests serialize across waves, so
every step still trains on its predecessor's params.
``interleave=False`` restores the synchronous FIFO loop, which runs
:class:`~repro_torch.core.exec.SyncHostEngine` (paced when ``bus_gbps``
is given) and doubles as the speedup baseline.

The service runs where ``device`` says: the CUDA card when None (raises
without one); ``device="cpu"`` runs it on the host with the copy-stream
engine's CPU emulation.  Request tensors must lie on that device.

Warm-up (lazy on first enqueue, or explicit via ``warmup()``) compiles one
plan per bucket and replays it once on dummy data, so live traffic never
pays the compile or the first replay. When ``device_budget_bytes`` is
omitted the budget is *derived*: the smallest QoS class's share = the
largest bucket's packed peak plus the session's optimizer tenancy, and the
budget scales the other classes' shares weight-proportionally from there —
i.e. "exactly enough arena for every slot to train the biggest bucket".
With offloaded moments the share shrinks vs the all-resident
counterfactual, so the same physical arena admits more sessions
(``report()["optim_offload"]["sessions_per_arena_x"]``). Passing a smaller
budget squeezes tenants: plans re-pack down the swap escalation ladder, and
sessions whose plans cannot fit are rejected, not overcommitted.

The fault-injection hook (:class:`repro_torch.runtime.fault.FaultInjector`)
is consulted once per dequeued request — and, under interleaving, once per
session per scheduler round, so a kill can land *mid-step at a phase
boundary*. Either way the session is torn down and its arena reservation
released before anything else happens, modelling the OS reclaiming an
opportunistic on-device training job.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import ArenaBudgetError, MemoryPlanConfig, compile_plan
from repro_torch.core.exec import DeviceStreamEngine, SyncHostEngine
from repro_torch.core.graph import LayerGraph
from repro_torch.device import DeviceLike
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve.admission import (AdmissionController, QosClass,
                                         ServeStats)
from repro_torch.serve.buckets import (PlanCache, choose_bucket, dummy_batch,
                                       pad_to_bucket)
from repro_torch.serve.scheduler import SessionWork, StepScheduler
from repro_torch.serve.servable import ServablePersonalizer


@contextlib.contextmanager
def _deterministic_steps():
    """cuDNN's deterministic algorithms while a drain runs.  The default
    backward-filter algorithms may sum with atomics, in another order on
    every run, so a step's grads would depend on the run and not only on
    its params and batch: an interleaved drain and a FIFO one of the same
    traffic would drift apart step by step."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


@dataclasses.dataclass(eq=False)
class Request:
    user: str
    x: torch.Tensor
    y: torch.Tensor
    qos: Optional[str] = None
    arrival: int = 0                 # global submission sequence number
    enqueued_at: float = 0.0
    result: Optional["StepResult"] = None


@dataclasses.dataclass
class StepResult:
    """Outcome of one submitted fine-tune request."""
    user: str
    status: str                      # "ok" | "rejected" | "killed"
    reason: str = ""
    bucket: Optional[int] = None
    loss: float = float("nan")
    step: int = 0
    arena_share_bytes: int = 0
    peak_bytes: int = 0              # measured HBM high water for this step
    wall_time_s: float = 0.0
    qos: str = "standard"
    queue_wait_s: float = 0.0        # enqueue -> processing start

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class PersonalizationService:
    """Multi-tenant personalization over one shared device arena."""

    def __init__(self, graph: LayerGraph, *,
                 buckets: Sequence[int] = (8, 16),
                 max_live_sessions: int = 4,
                 device_budget_bytes: Optional[int] = None,
                 config: Optional[MemoryPlanConfig] = None,
                 qos: Optional[Sequence[QosClass]] = None,
                 interleave: bool = True,
                 bus_gbps: Optional[float] = None,
                 bus_latency_s: float = 0.0,
                 lr: float = 0.05, momentum: float = 0.9,
                 injector: Optional[FaultInjector] = None,
                 seed: int = 0, device: DeviceLike = None) -> None:
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.graph = graph
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.config = config or MemoryPlanConfig()
        self.servable = ServablePersonalizer(
            graph, lr=lr, momentum=momentum, seed=seed, device=device)
        self.device = self.servable.device
        self.cache = PlanCache()
        self.injector = injector
        self.stats = ServeStats()
        self.admission: Optional[AdmissionController] = None
        self.interleave = bool(interleave)
        self.bus_gbps = bus_gbps       # emulated bus pacing (None = off)
        self.bus_latency_s = float(bus_latency_s)
        self._qos = tuple(qos) if qos is not None else None
        self._max_live_sessions = max_live_sessions
        self._device_budget_bytes = device_budget_bytes
        self._queue: Deque[Request] = deque()
        self._arrivals = 0
        self._warm = False
        self._scheduler: Optional[StepScheduler] = None
        # populated by warmup() when the budget is derived and the plans
        # carry an optimizer-offload plan (config.optim_offload)
        self._optim_accounting: Optional[Dict[str, Any]] = None

    # -- warm-up ----------------------------------------------------------

    def warmup(self) -> None:
        """Compile + dummy-replay every bucket; derive the budget if unset.

        Idempotent.  With an explicit ``device_budget_bytes`` this raises
        :class:`~repro_torch.core.ArenaBudgetError` when even one bucket cannot
        pack inside the smallest class's share — a configuration error,
        unlike per-request budget failures which reject gracefully.
        """
        if self._warm:
            return
        plans = {}
        if self._device_budget_bytes is None:
            probes = {b: compile_plan(self.graph, self.config, batch=b)
                      for b in self.buckets}
            # A session's device footprint is its activation arena peak
            # plus its optimizer tenancy.  Under optim_offload that
            # tenancy is the packed working region (optim_device_bytes),
            # not the all-resident moments — the share shrinks and the
            # same physical arena admits more sessions.
            needed = max(cp.peak_bytes + cp.optim_device_bytes
                         for cp in probes.values())
            self._optim_accounting = self._derive_optim_accounting(
                probes, needed)
            self.admission = self._make_admission(
                self._derive_budget(needed))
            for b, cp in probes.items():
                self.cache.seed(self.graph, b, self.config,
                                self.admission.arena_share_bytes, cp)
            plans = probes
        else:
            self.admission = self._make_admission(self._device_budget_bytes)
            smallest = min(self.admission.share_for(c.name)
                           for c in self.admission.qos)
            for b in self.buckets:
                plans[b] = self.cache.get_or_compile(
                    self.graph, self.config, bucket=b,
                    arena_budget_bytes=smallest)
        for b, cp in plans.items():
            x, y = dummy_batch(self.graph, b, device=self.device)
            cp.loss_and_grads(self.servable.base_params, x, y,
                              engine=self._fifo_engine())
        self._warm = True

    def _make_admission(self, budget: int) -> AdmissionController:
        return AdmissionController(
            max_live_sessions=self._max_live_sessions,
            device_budget_bytes=budget, qos=self._qos)

    def _derive_budget(self, needed: int) -> int:
        """The smallest budget whose *minimum* class share fits ``needed``
        bytes (single default class: exactly ``needed x max_live``, the
        historical derived budget)."""
        classes = self._qos or (QosClass("standard", 1.0,
                                         slots=self._max_live_sessions),)
        weight_units = sum(c.weight * c.slots for c in classes)
        min_weight = min(c.weight for c in classes)
        budget = int(math.ceil(needed * weight_units / min_weight))
        # integer floors can shave a byte off a share: nudge until the
        # smallest class share actually fits the probe peak
        while int(budget * min_weight / weight_units) < needed:
            budget += self._max_live_sessions
        return budget

    def _derive_optim_accounting(self, probes, share: int
                                 ) -> Optional[Dict[str, Any]]:
        """How much arena the optimizer offload bought back per session.

        ``share_resident`` is the counterfactual share with the moments
        fully device-resident; ``sessions_per_arena_x`` is how many more
        sessions the same physical arena (``share_resident x slots``)
        admits at the offloaded share."""
        opts = [cp.optim_plan for cp in probes.values()
                if cp.optim_plan is not None]
        if not opts:
            return None
        resident = max(op.resident_bytes for op in opts)
        share_resident = max(cp.peak_bytes for cp in probes.values()) \
            + resident
        arena = share_resident * self._max_live_sessions
        return {
            "share_bytes": share,
            "share_resident_bytes": share_resident,
            "optim_device_bytes": max(op.device_peak_bytes for op in opts),
            "optim_resident_bytes": resident,
            "sessions_in_resident_arena": arena // max(1, share),
            "sessions_per_arena_x": (arena // max(1, share))
            / self._max_live_sessions,
        }

    # -- the request loop -------------------------------------------------

    def submit(self, user: str, x: torch.Tensor, y: torch.Tensor, *,
               qos: Optional[str] = None) -> StepResult:
        """Enqueue one fine-tune request and drain the queue; returns this
        request's result (earlier queued requests are processed first)."""
        req = self.enqueue(user, x, y, qos=qos)
        self.drain()
        assert req.result is not None
        return req.result

    def enqueue(self, user: str, x: torch.Tensor, y: torch.Tensor, *,
                qos: Optional[str] = None) -> Request:
        self.warmup()
        if qos is not None:
            self.admission.qos_class(qos)     # unknown class: raise early
        self._arrivals += 1
        req = Request(user, x, y, qos=qos, arrival=self._arrivals,
                      enqueued_at=time.perf_counter())
        self._queue.append(req)
        self.stats.submitted += 1
        self.stats.queue_depth_high_water = max(
            self.stats.queue_depth_high_water, len(self._queue))
        return req

    def drain(self) -> List[StepResult]:
        """Process the queue until empty; every request gets exactly one
        result (progress is guaranteed — nothing is ever requeued).

        Interleaved mode drains as one continuous stream: each user's
        first pending request opens a schedule cursor, and the moment a
        user's step completes the scheduler's ``follow_up`` refill opens
        that user's next request (after the update is applied) — so
        concurrency never dwindles through an end-of-queue convoy.
        Results come back in arrival order either way.  The steps run
        under cuDNN's deterministic algorithms, so the two modes give the
        same grads for the same traffic.
        """
        with _deterministic_steps():
            return self._drain()

    def _drain(self) -> List[StepResult]:
        if not self.interleave:
            out: List[StepResult] = []
            while self._queue:
                req = self._queue.popleft()
                req.result = self._process(req)
                out.append(req.result)
            return out
        pending: Dict[str, Deque[Request]] = {}
        while self._queue:
            req = self._queue.popleft()
            pending.setdefault(req.user, deque()).append(req)
        done = self._run_stream(pending)
        done.sort(key=lambda p: p[0])
        return [r for _, r in done]

    def end_session(self, user: str) -> bool:
        """Client is done: free the slot and the arena reservation."""
        released = self.admission.release(user) if self.admission else False
        closed = self.servable.close_session(user)
        return released or closed

    # -- internals --------------------------------------------------------

    def _prepare(self, req: Request) -> Union[StepResult, Tuple]:
        """Everything up to execution: kill point, bucket, admission,
        plan compile.  Returns the terminal :class:`StepResult` for
        traffic-shaped failures, else ``(sess, cp, bucket, xp, yp,
        mask, qos, queue_wait_s)``."""
        user = req.user
        queue_wait_s = time.perf_counter() - req.enqueued_at
        # Preemption point: the injector models the OS killing an
        # opportunistic training job.  Reservation and state are released
        # *before* the request is looked at — nothing leaks.
        if self.injector is not None \
                and self.injector.check(f"session:{user}"):
            released = self.admission.release(user)
            self.servable.close_session(user)
            self.stats.killed += 1
            self.stats.note_queue_wait(
                req.qos or self.admission.default_qos, queue_wait_s)
            return StepResult(
                user=user, status="killed",
                reason="fault injection"
                       + (" (arena reservation released)" if released
                          else " (no reservation held)"),
                qos=req.qos or self.admission.default_qos,
                queue_wait_s=queue_wait_s)
        n = int(req.x.shape[0])
        bucket = choose_bucket(n, self.buckets)
        if bucket is None:
            self.stats.rejected_bucket += 1
            self.stats.note_queue_wait(
                req.qos or self.admission.default_qos, queue_wait_s)
            return StepResult(
                user=user, status="rejected",
                reason=f"batch of {n} exceeds largest bucket "
                       f"{self.buckets[-1]}",
                qos=req.qos or self.admission.default_qos,
                queue_wait_s=queue_wait_s)
        sess = self.servable.sessions.get(user)
        if sess is None:
            share = self.admission.try_admit(user, qos=req.qos)
            if share is None:
                if not self.admission.live:
                    # a full box with zero live sessions can't drain itself
                    self.stats.deadlocks += 1
                self.stats.rejected_admission += 1
                qos = req.qos or self.admission.default_qos
                self.stats.note_queue_wait(qos, queue_wait_s)
                return StepResult(
                    user=user, status="rejected",
                    reason=f"no live-session slot in class {qos!r} "
                           f"({self.admission.max_live_sessions} live)",
                    qos=qos, queue_wait_s=queue_wait_s)
            sess = self.servable.open_session(user, share)
        qos = self.admission.qos_of(user)
        try:
            cp = self.cache.get_or_compile(
                self.graph, self.config, bucket=bucket,
                arena_budget_bytes=sess.arena_share_bytes)
        except ArenaBudgetError as e:
            self.admission.release(user)
            self.servable.close_session(user)
            self.stats.rejected_budget += 1
            self.stats.note_queue_wait(qos, queue_wait_s)
            return StepResult(
                user=user, status="rejected",
                reason=f"bucket {bucket} plan peak {e.best_peak_bytes} "
                       f"exceeds arena share {e.arena_budget_bytes}",
                qos=qos, queue_wait_s=queue_wait_s)
        xp, yp, mask = pad_to_bucket(req.x, req.y, bucket)
        # queue wait for the successful path is noted at execution start:
        # _process notes it here, the interleaved wave notes it when the
        # cursor opens (the scheduler measures it from enqueued_at)
        return sess, cp, bucket, xp, yp, mask, qos, queue_wait_s

    def _process(self, req: Request) -> StepResult:
        """The synchronous FIFO path (PR 7 semantics, the baseline).

        Under emulated-bus pacing (``bus_gbps``) this path pays every
        transfer's bus time synchronously — a blocking engine exposes the
        full cost the interleaved scheduler exists to hide."""
        prepared = self._prepare(req)
        if isinstance(prepared, StepResult):
            return prepared
        sess, cp, bucket, xp, yp, mask, qos, queue_wait_s = prepared
        self.stats.note_queue_wait(qos, queue_wait_s)
        loss, exec_stats = self.servable.train_step(
            sess, cp, xp, yp, mask=mask, engine=self._fifo_engine())
        return self._complete(req.user, sess, bucket, loss, exec_stats,
                              qos, queue_wait_s)

    def _complete(self, user: str, sess, bucket: Optional[int],
                  loss: float, exec_stats, qos: str,
                  queue_wait_s: float) -> StepResult:
        ss = self.stats.session(user, sess.arena_share_bytes, qos)
        ss.steps += 1
        ss.last_loss = loss
        ss.peak_bytes = max(ss.peak_bytes, exec_stats.hbm_high_water)
        ss.wall_time_s += exec_stats.wall_time_s
        self.stats.completed += 1
        self.stats.qos_stats(qos).completed += 1
        return StepResult(
            user=user, status="ok", bucket=bucket, loss=loss,
            step=sess.step, arena_share_bytes=sess.arena_share_bytes,
            peak_bytes=exec_stats.hbm_high_water,
            wall_time_s=exec_stats.wall_time_s, qos=qos,
            queue_wait_s=queue_wait_s)

    def _fifo_engine(self) -> SyncHostEngine:
        """The synchronous engine of the FIFO path: blocking copies on
        the service's device, paced when ``bus_gbps`` is set."""
        return SyncHostEngine(self.device, bus_gbps=self.bus_gbps,
                              bus_latency_s=self.bus_latency_s)

    # -- interleaved draining ---------------------------------------------

    def _get_scheduler(self) -> StepScheduler:
        if self._scheduler is None:
            engine = DeviceStreamEngine(self.device, bus_gbps=self.bus_gbps,
                                        bus_latency_s=self.bus_latency_s)
            self._scheduler = StepScheduler(engine=engine,
                                            injector=self.injector)
        return self._scheduler

    def _run_stream(self, pending: Dict[str, Deque[Request]]
                    ) -> List[Tuple[int, StepResult]]:
        """Interleave every queued request as one continuous stream.

        Each user's first preparable request opens a cursor; whenever a
        session finishes, the outcome is folded (update applied, result
        recorded) and the scheduler's ``follow_up`` refill immediately
        opens that user's next queued request — same-user requests still
        serialize (each step trains on the previous step's params), but
        different users' later requests never wait for a wave barrier."""
        done: List[Tuple[int, StepResult]] = []
        ctx: Dict[int, Tuple] = {}       # arrival -> (req, sess, bucket)

        def next_work(user: str) -> Optional[SessionWork]:
            q = pending.get(user)
            while q:
                req = q.popleft()
                prepared = self._prepare(req)
                if isinstance(prepared, StepResult):
                    req.result = prepared
                    done.append((req.arrival, prepared))
                    continue           # terminal result; try the next one
                sess, cp, bucket, xp, yp, mask, qos, _ = prepared
                ctx[req.arrival] = (req, sess, bucket)
                return SessionWork(
                    user=req.user, arrival=req.arrival, qos=qos,
                    weight=self.admission.qos_class(qos).weight,
                    base_offset=self.admission.base_offset(req.user),
                    share_bytes=sess.arena_share_bytes, cp=cp, x=xp, y=yp,
                    mask=mask,
                    params_fn=(lambda s=sess:
                               self.servable.merged_params(s)),
                    enqueued_at=req.enqueued_at)
            return None

        def fold(oc) -> None:
            req, sess, bucket = ctx[oc.arrival]
            if oc.status == "killed":
                released = self.admission.release(oc.user)
                self.servable.close_session(oc.user)
                self.stats.killed += 1
                req.result = StepResult(
                    user=oc.user, status="killed",
                    reason=oc.reason
                           + (" (arena reservation released)" if released
                              else " (no reservation held)"),
                    qos=oc.qos, queue_wait_s=oc.queue_wait_s)
            else:
                self.servable.apply_update(sess, oc.grads)
                req.result = self._complete(
                    oc.user, sess, bucket, oc.loss, oc.stats, oc.qos,
                    oc.queue_wait_s)
            done.append((req.arrival, req.result))

        def follow_up(oc) -> Optional[SessionWork]:
            fold(oc)
            return next_work(oc.user)

        works = [w for w in (next_work(u) for u in list(pending))
                 if w is not None]
        if works:
            self._get_scheduler().run(works, self.stats,
                                      follow_up=follow_up)
        # the losses stayed on the card until the stream's end
        for _, r in done:
            if r.ok:
                r.loss = float(r.loss)
                ss = self.stats.sessions[r.user]
                ss.last_loss = float(ss.last_loss)
        return done

    # -- reporting --------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        rep = {
            "model": self.graph.name,
            "buckets": list(self.buckets),
            "interleave": self.interleave,
            "plan_cache": self.cache.report(),
            "serve": self.stats.report(),
        }
        if self.admission is not None:
            rep["admission"] = self.admission.report()
        if self._scheduler is not None and self._scheduler.last_report:
            rep["scheduler"] = self._scheduler.report()
        if self._optim_accounting is not None:
            rep["optim_offload"] = dict(self._optim_accounting)
        return rep
