"""Phase-interleaved multi-session execution.

Port of ``repro/serve/scheduler.py``.  The FIFO service trains one
session at a time, so the transfer engine idles whenever the single live
session computes and vice versa.  :class:`StepScheduler` fixes that at the
schedule level: it holds N admitted sessions' in-flight
:class:`~repro_torch.core.exec.ScheduleCursor`\\ s and round-robins them
*at phase boundaries* through one shared
:class:`~repro_torch.core.exec.AsyncDeviceBackend` /
:class:`~repro_torch.core.exec.DeviceStreamEngine` (one CUDA copy
stream).  A phase boundary is the
natural preemption point the lowered ``ExecutionSchedule`` already
defines: all of a phase's DMA has been issued but need not be fenced
until a later phase computes — so while session A's ``SwapOut`` /
``Prefetch`` / ``OptPrefetch`` copies are on the bus, the scheduler
advances session B's ``Compute`` phases, and A's DMA hides under B's
compute.  That cross-session overlap is measured, not asserted, and
credited to the waiting session's ``SwapExecStats.cross_hidden_dma_s``.
On the card the host only queues work, so host time is not device time:
the shared engine times every phase on the compute stream and every copy
on the copy stream with CUDA events, and once the wave is done
intersects each session's hidden copy time with the *other* sessions'
phases (the card's clock).  A session's end makes the host wait for
nothing: its grads and loss stay on the card, the caller's update is
queued behind them, and the wave's one synchronisation reads the losses
and the measured splits.  On the CPU, where the emulated bus runs on
the host clock, every second one session spends computing while another
session's transfers are in flight is credited to the waiting session, as
the reference does.  ``report()["cross_hidden_clock"]`` names the clock.

Safety before speed, in the house style (prove-then-run):

* admission: cursors only come from ``backend.start(...)``, which runs
  the verified-schedule admission gate, and the scheduler re-checks
  :func:`~repro_torch.core.verify.is_verified` per cursor;
* aliasing: before any cursor advances,
  :func:`~repro_torch.core.verify.verify_interleaving` proves the admitted
  sessions' arena shares pairwise disjoint and every plan peak inside
  its share (the ``cross_session_arena`` check, mutation class 12);
* equivalence: each completed session's replayed stream must equal the
  compiled op list — positionally, or failing that by
  :func:`~repro_torch.core.verify.schedules_equivalent` — before its result
  is released.

On the card the round order reads each session's oldest copy with
``event.query()`` (a scheduling hint, not a measurement): a session whose
copy has landed runs first, one still copying is held while another can
run, so its fence does not stall the shared compute stream.

QoS weighting: each round a session receives one phase advance per whole
unit of its class weight, so a premium (weight-2) tenant progresses two
phases per round while standard tenants take one.  Every extra advance
increments the *waiting* sessions' classes' ``bypassed_phases`` counter,
making the policy's starvation observable (``ServeStats.by_qos``).  Ties
are broken deterministically by global arrival sequence number.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from repro_torch.core.exec import (AsyncDeviceBackend, DeviceStreamEngine,
                                   SessionScopedEngine)
from repro_torch.core.verify import (is_verified, schedules_equivalent,
                                     verify_interleaving)
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve.admission import ServeStats


@dataclasses.dataclass(eq=False)
class SessionWork:
    """One admitted request, ready to interleave (at most one per user
    per :meth:`StepScheduler.run` wave — same-user requests serialize
    across waves so each step trains on the previous step's params)."""

    user: str
    arrival: int                 # global submission sequence — the tie-break
    qos: str
    weight: float
    base_offset: int             # the session's share in the physical arena
    share_bytes: int
    cp: Any                      # CompiledMemoryPlan for the user's bucket
    x: Any
    y: Any
    mask: Any
    # evaluated when the cursor opens, so a chained request sees the
    # params produced by the user's previous completed step
    params_fn: Callable[[], Any]
    enqueued_at: Optional[float] = None


@dataclasses.dataclass
class StepOutcome:
    """What one interleaved step produced (the service folds this into a
    :class:`~repro_torch.serve.service.StepResult` and applies the
    update)."""

    user: str
    arrival: int
    qos: str
    status: str                  # "ok" | "killed"
    reason: str = ""
    # a 0-dim device tensor while the wave runs (``follow_up`` sees it
    # so), a float once :meth:`StepScheduler.run` returns
    loss: Any = float("nan")
    grads: Optional[Dict[str, Any]] = None
    stats: Any = None            # SwapExecStats, None when killed
    queue_wait_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class _Live:
    """One session's in-flight cursor inside a wave."""

    def __init__(self, work: SessionWork, cursor,
                 start_after: int = 0) -> None:
        self.work = work
        self.cursor = cursor
        self.alive = True
        self.queue_wait_s = 0.0
        # software-pipeline prologue: this session holds at phase 0 until
        # the wave's global advance counter reaches start_after, so the
        # initial sessions de-phase instead of marching in lock-step
        # (lock-step means every session hits the plan's transfer-heavy
        # regions at once — the bus bursts then idles)
        self.start_after = start_after


class StepScheduler:
    """Round-robin N sessions' schedule cursors over one copy stream.

    ``engine`` is the shared :class:`DeviceStreamEngine`: on the CUDA card
    when None (raises without one)."""

    def __init__(self, *, backend: Optional[AsyncDeviceBackend] = None,
                 engine: Optional[DeviceStreamEngine] = None,
                 injector: Optional[FaultInjector] = None) -> None:
        self.backend = backend if backend is not None else AsyncDeviceBackend()
        self.engine = engine if engine is not None else DeviceStreamEngine()
        self.injector = injector
        self.last_report: Dict[str, Any] = {}

    # ------------------------------------------------------------- admission
    def _check_interleaving(self, works: Sequence[SessionWork]) -> None:
        """Prove the wave's arena shares disjoint and every plan in-share
        before a single phase executes (cross_session_arena)."""
        from repro_torch.core.verify import SessionArenaSlice
        slices = [SessionArenaSlice(
            session=w.user, qos=w.qos, base_offset=w.base_offset,
            share_bytes=w.share_bytes,
            peak_bytes=w.cp.peak_bytes + w.cp.optim_device_bytes)
            for w in works]
        verify_interleaving(slices).raise_if_errors()

    def _open(self, work: SessionWork) -> _Live:
        """Admit one work item: verified backend.start over a
        session-scoped view of the shared engine."""
        cp = work.cp
        scoped = SessionScopedEngine(self.engine,
                                     f"{work.user}#{work.arrival}")
        cursor = self.backend.start(
            cp.graph, work.params_fn(), work.x, work.y,
            schedule=cp.schedule, ordered=cp.ordered, plan=cp.plan,
            lowered=cp.lowered, mask=work.mask, engine=scoped)
        # defense in depth: start() verifies unverified plan-backed
        # schedules on admission; a cursor for an unverified schedule
        # must be impossible here
        assert is_verified(cp.lowered), \
            f"unverified schedule admitted for {work.user!r}"
        return _Live(work, cursor)

    @staticmethod
    def _stagger_stride(works: Sequence[SessionWork]) -> int:
        """Global-advance stride between consecutive sessions' starts:
        one plan's phase-group count spread over the wave (a phase group
        is a run of lowered ops sharing one EO — what one
        ``ScheduleCursor.advance`` executes)."""
        if len(works) < 2:
            return 0

        def groups(cp) -> int:
            n, cur = 0, None
            for op in cp.lowered.ops:
                if cur is None or op.eo != cur:
                    n, cur = n + 1, op.eo
            return n

        phases = min(groups(w.cp) for w in works)
        return max(1, phases // len(works)) if phases else 0

    def _prove_replay(self, live: _Live, proved: Set[int]) -> None:
        """The completed session's replayed stream must be the compiled op
        list (or a proven-equivalent stream).  Proofs are memoized per
        lowered schedule per wave — every session of one bucket replays
        the same plan, so one proof covers the fleet."""
        cp = live.work.cp
        stats = live.cursor.stats
        if stats.replayed_ops == cp.lowered.ops:
            return                     # positionally identical — trivially ok
        key = id(cp.lowered)
        if key in proved:
            return
        schedules_equivalent(cp.lowered, stats.replayed_ops,
                             ordered=cp.ordered,
                             plan=cp.plan).raise_if_errors()
        proved.add(key)

    # ------------------------------------------------------------------ run
    def run(self, works: Sequence[SessionWork],
            stats: Optional[ServeStats] = None,
            follow_up: Optional[Callable[[StepOutcome],
                                         Optional[SessionWork]]] = None,
            ) -> List[StepOutcome]:
        """Interleave one wave of sessions to completion.

        Weighted round-robin at phase boundaries in arrival order; fault
        injection is consulted per session per round (the phase boundary
        is the kill point); returns one :class:`StepOutcome` per work
        item, in arrival order.

        ``follow_up`` makes the wave a continuous stream: it is called
        with each session's outcome the moment that session finishes and
        may return the *next* :class:`SessionWork` to open (typically the
        same user's next queued request, after the caller applied the
        update) — so the bus never idles through an end-of-wave convoy
        while stragglers drain.  The refilled work joins the round-robin
        immediately and is re-proven against the still-active sessions'
        arena shares before its first phase executes.
        """
        works = sorted(works, key=lambda w: w.arrival)
        # on the card the engine credits cross-session overlap itself
        host_clock = not self.engine.cuda
        users = [w.user for w in works]
        if len(set(users)) != len(users):
            raise ValueError(
                f"one work item per user per wave, got {users}")
        self._check_interleaving(works)
        all_works: List[SessionWork] = list(works)
        outcomes: Dict[int, StepOutcome] = {}
        proved: Set[int] = set()
        active: List[_Live] = []
        t_wave0 = time.perf_counter()

        def open_live(w: SessionWork, start_after: int = 0) -> None:
            live = self._open(w)
            live.start_after = start_after
            active.append(live)
            if w.enqueued_at is not None and stats is not None:
                wait = time.perf_counter() - w.enqueued_at
                stats.note_queue_wait(w.qos, wait)
                live.queue_wait_s = wait

        # prologue: stagger session i by i * (phases/N) global advances so
        # the wave starts de-phased — session 0's transfer-heavy regions
        # land under sessions 1..N-1's compute and vice versa.  Refilled
        # follow-up work needs no stagger: it opens at a completion, which
        # is already de-phased.
        stride = self._stagger_stride(works)
        for i, w in enumerate(works):
            open_live(w, start_after=i * stride)
        rounds = 0
        phase_advances = 0

        def refill(outcome: StepOutcome) -> None:
            if follow_up is None:
                return
            nxt = follow_up(outcome)
            if nxt is None:
                return
            survivors = [s.work for s in active if s.alive]
            if any(s.user == nxt.user for s in survivors):
                raise ValueError(
                    f"follow-up work for {nxt.user!r} while that user is "
                    f"still active")
            self._check_interleaving(survivors + [nxt])
            all_works.append(nxt)
            open_live(nxt)

        def finish(live: _Live, status: str, reason: str = "") -> None:
            w = live.work
            if status == "ok":
                loss, grads, st = live.cursor.result()
                self._prove_replay(live, proved)
                outcomes[w.arrival] = StepOutcome(
                    user=w.user, arrival=w.arrival, qos=w.qos, status="ok",
                    loss=loss, grads=grads, stats=st,
                    queue_wait_s=getattr(live, "queue_wait_s", 0.0))
            else:
                outcomes[w.arrival] = StepOutcome(
                    user=w.user, arrival=w.arrival, qos=w.qos,
                    status="killed", reason=reason,
                    queue_wait_s=getattr(live, "queue_wait_s", 0.0))
            live.alive = False
            refill(outcomes[w.arrival])

        while active:
            rounds += 1
            advanced_any = False
            # stall-aware round order: a session whose in-flight transfers
            # are all complete cannot stall on a fence, so it runs first;
            # a session still waiting on the bus runs last — by its turn
            # the clock has moved under the others' compute.  sort() is
            # stable and every key is 0.0 without pacing, so the order
            # degrades to the deterministic arrival order.
            now = time.perf_counter()
            order = sorted(
                active,
                key=lambda s: max(0.0, getattr(s.cursor.engine,
                                               "next_ready_at", 0.0) - now))
            for live in order:
                w = live.work
                if advanced_any and (
                        phase_advances < live.start_after
                        or getattr(live.cursor.engine, "next_ready_at", 0.0)
                        > time.perf_counter()):
                    # hold: still in the prologue, or this session's bus
                    # transfers aren't complete yet — let ready sessions'
                    # compute run the clock past its completion instead
                    # of sleeping in its fence.  The round's first (least
                    # at-risk) session always advances, so the wave can
                    # never stall collectively.
                    continue
                # the phase boundary is the preemption point: a kill here
                # models the OS reclaiming the job mid-step
                if self.injector is not None \
                        and self.injector.check(f"session:{w.user}"):
                    live.cursor.abort()
                    finish(live, "killed",
                           "fault injection at phase boundary "
                           f"{live.cursor.phases_done}/"
                           f"{live.cursor.phases_total}")
                    continue
                credits = max(1, int(live.work.weight))
                for i in range(credits):
                    more = live.cursor.advance()
                    phase_advances += 1
                    advanced_any = True
                    dt = live.cursor.last_advance_s
                    # cross-session overlap on the host clock: while this
                    # session computed for dt, every *other* session with
                    # DMA in flight had that DMA hidden under foreign
                    # compute
                    for other in active if host_clock else ():
                        if other is not live and other.alive \
                                and other.cursor.has_inflight_dma:
                            other.cursor.stats.cross_hidden_dma_s += dt
                    # fairness, observable: an extra (weight-funded)
                    # advance bypasses every other runnable session
                    if i > 0 and stats is not None:
                        for other in active:
                            if other is not live and other.alive:
                                stats.qos_stats(
                                    other.work.qos).bypassed_phases += 1
                    if not more:
                        finish(live, "ok")
                        break
            active = [s for s in active if s.alive]

        # the wave's one wait for the card: it credits every session's
        # measured DMA split (cross-session overlap included) and makes
        # the losses readable
        self.engine.settle()
        done = [outcomes[w.arrival]
                for w in sorted(all_works, key=lambda w: w.arrival)]
        ok = [o for o in done if o.ok]
        for o in ok:
            o.loss = float(o.loss)
        agg = {
            "sessions": len(all_works),
            "completed": len(ok),
            "killed": len(done) - len(ok),
            "rounds": rounds,
            "phase_advances": phase_advances,
            "wall_time_s": time.perf_counter() - t_wave0,
            "equivalence_proofs": len(proved),
            "verify_errors": 0,        # raise-on-error above, so 0 here
            "cross_hidden_dma_s": sum(o.stats.cross_hidden_dma_s
                                      for o in ok),
            "cross_hidden_clock": "host" if host_clock else "device",
            "hidden_dma_s": sum(o.stats.hidden_dma_s for o in ok),
            "exposed_dma_s": sum(o.stats.exposed_dma_s for o in ok),
            "opt_hidden_dma_s": sum(o.stats.opt_hidden_dma_s for o in ok),
            "opt_exposed_dma_s": sum(o.stats.opt_exposed_dma_s
                                     for o in ok),
        }
        self.last_report = agg
        return done

    def report(self) -> Dict[str, Any]:
        return dict(self.last_report)
