"""Executor subsystem: layer math, activation store, pluggable backends.

The layer-operation-basis training executor (NNTrainer §3/§4, Figure 2(b))
split along its three concerns:

* :mod:`repro_torch.core.exec.layers`   — pure per-layer F/CG/CD math, loss
  calculus, the plain planned walk and the ``torch.autograd`` reference;
* :mod:`repro_torch.core.exec.store`    — residency trackers + activation
  store with the :class:`TransferEngine` seam (synchronous host round
  trips vs the CUDA copy stream into one pinned host pool);
* :mod:`repro_torch.core.exec.backends` — the :class:`ExecutorBackend`
  protocol and its three implementations, :class:`SimulatedBackend`
  (default) and :class:`AsyncDeviceBackend`, both replaying the compiled
  :class:`repro_torch.core.plan.ExecutionSchedule` verbatim, and
  :class:`JitBlocksBackend`, one dispatch per proven-fusable block (a
  CUDA-graph replay over the packed device arena on the card).

Select a backend declaratively via ``MemoryPlanConfig(executor=...)``.
"""

from repro_torch.core.exec.backends import (BACKENDS, AsyncDeviceBackend,
                                            ExecutorBackend, JitBlocksBackend,
                                            ScheduleCursor, SimulatedBackend,
                                            get_backend,
                                            swap_planned_loss_and_grads)
from repro_torch.core.exec.layers import (init_params, layer_calc_derivative,
                                          layer_calc_gradient, layer_forward,
                                          loss_derivative, loss_forward,
                                          planned_loss_and_grads,
                                          reference_forward,
                                          reference_loss_and_grads,
                                          sgd_update, sgd_update_)
from repro_torch.core.exec.store import (ActivationStore,
                                         ArenaActivationStore, DeviceArena,
                                         DeviceStreamEngine, HbmTracker,
                                         HostPool, SessionScopedEngine,
                                         SwapExecStats, SyncHostEngine,
                                         TransferEngine)

__all__ = [
    # backends
    "ExecutorBackend", "SimulatedBackend", "AsyncDeviceBackend",
    "JitBlocksBackend",
    "BACKENDS", "get_backend", "swap_planned_loss_and_grads",
    "ScheduleCursor",
    # store + engines
    "ActivationStore", "ArenaActivationStore", "DeviceArena", "HbmTracker",
    "HostPool", "SwapExecStats",
    "TransferEngine", "SyncHostEngine", "DeviceStreamEngine",
    "SessionScopedEngine",
    # layer math
    "init_params", "layer_forward", "layer_calc_gradient",
    "layer_calc_derivative", "loss_forward", "loss_derivative",
    "planned_loss_and_grads", "reference_forward",
    "reference_loss_and_grads", "sgd_update", "sgd_update_",
]
