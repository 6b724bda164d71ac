"""Fault tolerance & straggler mitigation for long multi-pod runs.

Components:

* ``Heartbeat`` — per-host liveness file + monitor; a host missing
  ``timeout`` seconds of beats is declared dead, triggering restart from
  the latest checkpoint (the coordinator pattern; on Cloud TPU the restart
  itself is performed by the job scheduler — this module decides *when*
  and *from which step*).

* ``StepWatchdog`` — straggler mitigation: tracks a robust moving median
  of step times; a step exceeding ``factor`` x median flags the slow host.
  Remedies escalate: log -> exclude host from the next data round
  (shrink DP, elastic) -> request restart.  At dry-run scale we expose the
  detection + decision logic and unit-test it with synthetic timings.

* ``RestartPolicy`` — bounded exponential backoff with a failure budget
  (crash loops abort rather than burn the job's allocation).

* ``elastic_new_mesh`` — recompute the mesh after losing hosts: drops the
  data-parallel extent to the largest supported divisor and returns the
  re-shard plan (checkpoint restore handles the actual movement).

* ``FaultInjector`` — deterministic fault-injection hook for tests and
  chaos drills: arm a kill against a named target (a serving session, a
  host, a step) and the owning loop consults ``check(target)`` at its
  preemption points; the hook fires once after the armed number of checks.
  On-device training runs opportunistically (idle, charging) and gets
  killed constantly — the serving queue uses this hook to prove a session
  killed mid-queue releases its arena reservation.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple


# --------------------------------------------------------------------------
# Heartbeats
# --------------------------------------------------------------------------

class Heartbeat:
    def __init__(self, directory: str, host_id: int):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.path = self.dir / f"host_{host_id}.hb"

    def beat(self, step: int) -> None:
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"t": time.time(), "step": step}))
        tmp.rename(self.path)

    @staticmethod
    def dead_hosts(directory: str, n_hosts: int, *,
                   timeout: float = 120.0,
                   now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        dead = []
        d = Path(directory)
        for h in range(n_hosts):
            p = d / f"host_{h}.hb"
            if not p.exists():
                dead.append(h)
                continue
            try:
                t = json.loads(p.read_text())["t"]
            except Exception:  # noqa: BLE001
                dead.append(h)
                continue
            if now - t > timeout:
                dead.append(h)
        return dead


# --------------------------------------------------------------------------
# Straggler detection
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: Optional[int]
    step_time: float
    median: float
    action: str            # "log" | "exclude" | "restart"


class StepWatchdog:
    def __init__(self, *, window: int = 32, factor: float = 2.0,
                 exclude_after: int = 3, restart_after: int = 8):
        self.window = window
        self.factor = factor
        self.exclude_after = exclude_after
        self.restart_after = restart_after
        self._times: List[float] = []
        self._slow_counts: Dict[Optional[int], int] = {}
        self.events: List[StragglerEvent] = []

    def record(self, step: int, step_time: float,
               slowest_host: Optional[int] = None) -> Optional[StragglerEvent]:
        self._times.append(step_time)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 5:
            return None
        med = statistics.median(self._times)
        if step_time <= self.factor * med:
            self._slow_counts.pop(slowest_host, None)
            return None
        c = self._slow_counts.get(slowest_host, 0) + 1
        self._slow_counts[slowest_host] = c
        if c >= self.restart_after:
            action = "restart"
        elif c >= self.exclude_after:
            action = "exclude"
        else:
            action = "log"
        ev = StragglerEvent(step, slowest_host, step_time, med, action)
        self.events.append(ev)
        return ev


# --------------------------------------------------------------------------
# Restart policy
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 20
    base_backoff_s: float = 5.0
    max_backoff_s: float = 300.0
    _count: int = 0

    def next_backoff(self) -> Optional[float]:
        """Seconds to wait before restart n, or None when budget exhausted."""
        if self._count >= self.max_restarts:
            return None
        b = min(self.base_backoff_s * (2 ** self._count), self.max_backoff_s)
        self._count += 1
        return b

    def reset(self) -> None:
        self._count = 0


# --------------------------------------------------------------------------
# Elastic rescale
# --------------------------------------------------------------------------

def elastic_new_mesh(n_hosts_alive: int, *, chips_per_host: int = 8,
                     model_par: int = 16) -> Tuple[Tuple[int, int], Dict]:
    """Largest (data, model) mesh on the surviving hosts.

    Model parallelism is pinned (weights are TP-sharded 16-way); the data
    axis shrinks to the largest extent the remaining chips support.  The
    global batch is preserved by raising gradient-accumulation microbatches
    proportionally (returned in the plan).
    """
    chips = n_hosts_alive * chips_per_host
    data = max(chips // model_par, 1)
    # data extent must divide the old extent for clean batch re-slicing
    while data > 1 and 16 % data not in (0,) and data * model_par > chips:
        data -= 1
    plan = {
        "data": data,
        "model": model_par,
        "microbatch_scale": max(16 // max(data, 1), 1),
    }
    return (data, model_par), plan


# --------------------------------------------------------------------------
# Deterministic fault injection
# --------------------------------------------------------------------------

class FaultInjector:
    """Arm kills against named targets; owning loops poll ``check``.

    ``arm_kill("session:alice", after=2)`` makes the third
    ``check("session:alice")`` return True (fire-once); earlier checks
    count down, unrelated targets are never disturbed.  Loops treat a True
    result exactly like an external preemption: tear the target down and
    release every resource it held.  Deterministic by construction — no
    clocks, no randomness — so tests can assert the precise step a session
    dies at.
    """

    def __init__(self) -> None:
        self._armed: Dict[str, int] = {}
        self.fired: List[str] = []

    def arm_kill(self, target: str, *, after: int = 0) -> None:
        """Fire on the ``after``-th subsequent check of ``target`` (0 = next)."""
        self._armed[target] = int(after)

    def check(self, target: str) -> bool:
        """Poll ``target``; True exactly once when its armed kill fires."""
        remaining = self._armed.get(target)
        if remaining is None:
            return False
        if remaining <= 0:
            del self._armed[target]
            self.fired.append(target)
            return True
        self._armed[target] = remaining - 1
        return False

    @property
    def armed(self) -> Tuple[str, ...]:
        return tuple(sorted(self._armed))
