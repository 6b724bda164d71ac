"""Multi-tenant personalization serving (paper §"Personalization examples").

Port of ``repro/serve``: PyTorch on one CUDA card, the copy-stream engine
carrying every session's swaps.

On-device personalization is a *serving* problem as much as a training
problem: one box hosts a shared pre-trained backbone and many users'
lightweight fine-tune state, training opportunistically as user data
arrives.  This package turns :func:`repro_torch.core.compile_plan` into
that serving stack:

* :mod:`repro_torch.serve.buckets` — sorted batch-size buckets,
  pad-to-bucket batching (exact numerics via sample masks), and the
  ``(model, bucket, config, budget) -> CompiledMemoryPlan`` compile cache.
* :mod:`repro_torch.serve.admission` — admission control:
  ``max_live_sessions`` tenants split one device-arena byte budget; the
  memory planner is the QoS lever (each session's plans must pack inside
  its share).
* :mod:`repro_torch.serve.servable` — ``ServablePersonalizer``: one frozen
  base parameter tree shared by every session + per-user trainable deltas
  and optimizer state.
* :mod:`repro_torch.serve.service` — ``PersonalizationService``: the
  request loop (``submit(user, x, y, qos=...) -> StepResult``) with
  graceful rejection and fault-injection kill points.
* :mod:`repro_torch.serve.scheduler` — ``StepScheduler``: phase-interleaved
  multi-session execution — N sessions' schedule cursors round-robin over
  one shared copy stream, so one tenant's DMA hides under another's
  compute (``drain`` default; ``interleave=False`` restores FIFO).

Quick start::

    from repro_torch.core.zoo import ZOO
    from repro_torch.serve import PersonalizationService

    svc = PersonalizationService(ZOO["lenet5"](), buckets=(8, 16),
                                 max_live_sessions=4)   # on the CUDA card
    res = svc.submit("alice", x, y)   # x: (n<=16, 3, 32, 32) on the card
    print(res.status, res.loss, svc.report())
"""

from repro_torch.serve.admission import (AdmissionController, QosClass,
                                         QosClassStats, ServeStats,
                                         SessionStats)
from repro_torch.serve.buckets import (PlanCache, choose_bucket, dummy_batch,
                                       pad_to_bucket)
from repro_torch.serve.scheduler import (SessionWork, StepOutcome,
                                         StepScheduler)
from repro_torch.serve.servable import ServablePersonalizer, Session
from repro_torch.serve.service import PersonalizationService, StepResult

__all__ = [
    "PersonalizationService", "StepResult",
    "ServablePersonalizer", "Session",
    "AdmissionController", "QosClass", "QosClassStats",
    "ServeStats", "SessionStats",
    "StepScheduler", "SessionWork", "StepOutcome",
    "PlanCache", "choose_bucket", "pad_to_bucket", "dummy_batch",
]
