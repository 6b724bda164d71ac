"""Admission control, QoS classes and serving statistics.

The device arena is the scarce resource: every live session's training
steps replay a memory plan whose packed peak must stay inside that
session's *share* of the arena.  Admission is therefore a byte-budget
problem, and the memory planner is the QoS lever — a tenant is admitted
iff (a) a live-session slot of its QoS class is free and (b)
:func:`repro_torch.core.compile_plan_under_budget` can pack its bucket plans
inside the class's share.  Sessions that die (or are killed by fault
injection) release their reservation immediately, so the arena can never
leak.

Shares are priced per :class:`QosClass`: the budget splits
weight-proportionally over the declared slots, so a ``premium`` class
with twice the weight of ``standard`` buys twice the arena share — its
plans pack with fewer swaps and its steps run measurably faster (the
planner, not a scheduler priority, is what the tenant pays for).  The
default is a single equal-share class, byte-identical to the historical
``device_budget_bytes // max_live_sessions`` policy; plans are cached per
(model, bucket, config, share), so each class warms its own cache entry
and tenants of one class still share plans fleet-wide.

Every slot owns a fixed *base offset* into the physical arena.  Each
session's plan packs its own offsets from 0 inside its share, so base
offsets partition the arena into pairwise-disjoint intervals — the
invariant :func:`repro_torch.core.verify.verify_interleaving` proves before the
phase-interleaved scheduler lets sessions share the device streams.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class QosClass:
    """One admission class: ``slots`` sessions at ``weight``-priced shares.

    ``weight`` scales the class's arena share relative to the other
    classes (share = budget x weight / sum(weight_i x slots_i)); bigger
    share -> the planner packs with fewer swaps -> faster steps.  The
    phase-interleaved scheduler also grants one extra phase advance per
    whole unit of weight each round, so a premium tenant progresses
    faster even when both classes' plans fit without swapping.
    """

    name: str
    weight: float = 1.0
    slots: int = 1

    def __post_init__(self):
        if not self.name:
            raise ValueError("QosClass needs a name")
        if self.weight <= 0:
            raise ValueError(f"QosClass {self.name!r}: weight must be > 0")
        if self.slots <= 0:
            raise ValueError(f"QosClass {self.name!r}: slots must be > 0")


@dataclasses.dataclass(frozen=True)
class _Reservation:
    """One live session's claim: class, priced share, arena base offset."""
    qos: str
    share_bytes: int
    base_offset: int


class AdmissionController:
    """Slot-per-class admission over one device-arena byte budget.

    With the default single class every tenant gets
    ``device_budget_bytes // max_live_sessions`` — deterministic and
    cache-hot, the historical policy.  Declaring :class:`QosClass` tiers
    splits the same budget weight-proportionally; plans are compiled per
    share, so each class fragments the plan cache exactly once.
    """

    def __init__(self, *, max_live_sessions: int,
                 device_budget_bytes: int,
                 qos: Optional[Sequence[QosClass]] = None) -> None:
        if max_live_sessions <= 0:
            raise ValueError("max_live_sessions must be positive")
        if device_budget_bytes <= 0:
            raise ValueError("device_budget_bytes must be positive")
        if qos is None:
            qos = (QosClass("standard", 1.0, slots=max_live_sessions),)
        self.qos: Tuple[QosClass, ...] = tuple(qos)
        names = [c.name for c in self.qos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate QoS class names: {names}")
        if sum(c.slots for c in self.qos) != max_live_sessions:
            raise ValueError(
                f"QoS slots {[(c.name, c.slots) for c in self.qos]} must "
                f"sum to max_live_sessions={max_live_sessions}")
        self.max_live_sessions = max_live_sessions
        self.device_budget_bytes = device_budget_bytes
        weight_units = sum(c.weight * c.slots for c in self.qos)
        self._share: Dict[str, int] = {
            c.name: int(device_budget_bytes * c.weight / weight_units)
            for c in self.qos}
        # fixed base offsets: the arena partitions into one interval per
        # slot, classes in declaration order, so shares never alias
        self._free: Dict[str, List[int]] = {c.name: [] for c in self.qos}
        offset = 0
        for c in self.qos:
            for _ in range(c.slots):
                self._free[c.name].append(offset)
                offset += self._share[c.name]
        self._live: Dict[str, _Reservation] = {}
        self.rejections = 0
        self.rejections_by_class: Dict[str, int] = {c.name: 0
                                                    for c in self.qos}

    @property
    def default_qos(self) -> str:
        return self.qos[0].name

    @property
    def arena_share_bytes(self) -> int:
        """The default class's share (the whole policy, pre-QoS)."""
        return self._share[self.default_qos]

    def share_for(self, qos: Optional[str] = None) -> int:
        return self._share[qos if qos is not None else self.default_qos]

    def qos_class(self, name: str) -> QosClass:
        for c in self.qos:
            if c.name == name:
                return c
        raise KeyError(f"unknown QoS class {name!r}; "
                       f"declared: {[c.name for c in self.qos]}")

    @property
    def live(self) -> Tuple[str, ...]:
        return tuple(sorted(self._live))

    @property
    def reserved_bytes(self) -> int:
        return sum(r.share_bytes for r in self._live.values())

    def reservation(self, user: str) -> Optional[_Reservation]:
        return self._live.get(user)

    def base_offset(self, user: str) -> int:
        return self._live[user].base_offset

    def qos_of(self, user: str) -> str:
        return self._live[user].qos

    def try_admit(self, user: str,
                  qos: Optional[str] = None) -> Optional[int]:
        """Reserve a slot + share for ``user``; None when the class is full.

        Idempotent for already-live users (their existing share is
        returned, nothing double-reserved — the requested ``qos`` must
        not contradict the live reservation).
        """
        existing = self._live.get(user)
        if existing is not None:
            if qos is not None and qos != existing.qos:
                raise ValueError(
                    f"session {user!r} is live in class "
                    f"{existing.qos!r}, cannot re-admit as {qos!r}")
            return existing.share_bytes
        name = qos if qos is not None else self.default_qos
        self.qos_class(name)                     # raises on unknown class
        free = self._free[name]
        if not free:
            self.rejections += 1
            self.rejections_by_class[name] += 1
            return None
        base = free.pop(0)
        share = self._share[name]
        self._live[user] = _Reservation(name, share, base)
        return share

    def release(self, user: str) -> bool:
        """Return ``user``'s slot to its class's pool; False if not live."""
        r = self._live.pop(user, None)
        if r is None:
            return False
        free = self._free[r.qos]
        free.append(r.base_offset)
        free.sort()                  # deterministic re-admission order
        return True

    def arena_slices(self, peaks: Optional[Mapping[str, int]] = None
                     ) -> List["SessionArenaSlice"]:
        """The live sessions as verifier slices (``peaks``: measured or
        planned device peak per user; defaults each to its share)."""
        from repro_torch.core.verify import SessionArenaSlice
        out = []
        for user in self.live:
            r = self._live[user]
            peak = r.share_bytes if peaks is None \
                else peaks.get(user, r.share_bytes)
            out.append(SessionArenaSlice(
                session=user, qos=r.qos, base_offset=r.base_offset,
                share_bytes=r.share_bytes, peak_bytes=peak))
        return out

    def report(self) -> Dict[str, Any]:
        live_by_class: Dict[str, int] = {c.name: 0 for c in self.qos}
        for r in self._live.values():
            live_by_class[r.qos] += 1
        return {
            "max_live_sessions": self.max_live_sessions,
            "device_budget_bytes": self.device_budget_bytes,
            "arena_share_bytes": self.arena_share_bytes,
            "live_sessions": len(self._live),
            "reserved_bytes": self.reserved_bytes,
            "rejections": self.rejections,
            "qos": {
                c.name: {
                    "weight": c.weight,
                    "slots": c.slots,
                    "share_bytes": self._share[c.name],
                    "live": live_by_class[c.name],
                    "rejections": self.rejections_by_class[c.name],
                } for c in self.qos
            },
        }


@dataclasses.dataclass
class SessionStats:
    """Per-tenant QoS counters, updated on every completed step."""
    user: str
    arena_share_bytes: int
    qos: str = "standard"
    steps: int = 0
    last_loss: float = float("nan")
    peak_bytes: int = 0          # max measured HBM high water across steps
    wall_time_s: float = 0.0     # sum of executor step wall times

    def steps_per_sec(self) -> float:
        return self.steps / self.wall_time_s if self.wall_time_s > 0 else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "user": self.user,
            "arena_share_bytes": self.arena_share_bytes,
            "qos": self.qos,
            "steps": self.steps,
            "last_loss": self.last_loss,
            "peak_bytes": self.peak_bytes,
            "wall_time_s": round(self.wall_time_s, 6),
            "steps_per_sec": round(self.steps_per_sec(), 3),
            "within_share": self.peak_bytes <= self.arena_share_bytes,
        }


@dataclasses.dataclass
class QosClassStats:
    """Per-class fairness counters: queue wait and observed starvation."""
    qos: str
    completed: int = 0
    queue_wait_s_total: float = 0.0
    queue_wait_high_water_s: float = 0.0
    # phase advances granted to *other* (higher-weight) classes' sessions
    # while one of this class's sessions sat runnable at a boundary — the
    # round-robin policy's starvation, observable instead of folklore
    bypassed_phases: int = 0

    def note_wait(self, seconds: float) -> None:
        self.queue_wait_s_total += seconds
        self.queue_wait_high_water_s = max(self.queue_wait_high_water_s,
                                           seconds)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "qos": self.qos,
            "completed": self.completed,
            "queue_wait_s_total": round(self.queue_wait_s_total, 6),
            "queue_wait_high_water_s": round(self.queue_wait_high_water_s,
                                             6),
            "bypassed_phases": self.bypassed_phases,
        }


@dataclasses.dataclass
class ServeStats:
    """Service-level counters: traffic, queueing, rejection taxonomy."""
    submitted: int = 0
    completed: int = 0
    rejected_admission: int = 0   # no live-session slot free
    rejected_bucket: int = 0      # batch larger than every bucket
    rejected_budget: int = 0      # plan cannot pack inside the arena share
    killed: int = 0               # sessions torn down by fault injection
    queue_depth_high_water: int = 0
    deadlocks: int = 0            # drain passes that made no progress
    queue_wait_s_total: float = 0.0        # dequeue-to-start, all requests
    queue_wait_high_water_s: float = 0.0
    sessions: Dict[str, SessionStats] = dataclasses.field(default_factory=dict)
    by_qos: Dict[str, QosClassStats] = dataclasses.field(default_factory=dict)

    def session(self, user: str, arena_share_bytes: int,
                qos: str = "standard") -> SessionStats:
        s = self.sessions.get(user)
        if s is None:
            s = self.sessions[user] = SessionStats(user, arena_share_bytes,
                                                   qos)
        return s

    def qos_stats(self, qos: str) -> QosClassStats:
        s = self.by_qos.get(qos)
        if s is None:
            s = self.by_qos[qos] = QosClassStats(qos)
        return s

    def note_queue_wait(self, qos: str, seconds: float) -> None:
        self.queue_wait_s_total += seconds
        self.queue_wait_high_water_s = max(self.queue_wait_high_water_s,
                                           seconds)
        self.qos_stats(qos).note_wait(seconds)

    def rejected(self) -> int:
        return (self.rejected_admission + self.rejected_bucket
                + self.rejected_budget)

    def report(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected(),
            "rejected_admission": self.rejected_admission,
            "rejected_bucket": self.rejected_bucket,
            "rejected_budget": self.rejected_budget,
            "killed": self.killed,
            "queue_depth_high_water": self.queue_depth_high_water,
            "deadlocks": self.deadlocks,
            "queue_wait_s_total": round(self.queue_wait_s_total, 6),
            "queue_wait_high_water_s": round(self.queue_wait_high_water_s,
                                             6),
            "by_qos": {q: s.as_dict()
                       for q, s in sorted(self.by_qos.items())},
            "sessions": {u: s.as_dict()
                         for u, s in sorted(self.sessions.items())},
        }
