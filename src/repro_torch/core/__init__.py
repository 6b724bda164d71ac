"""NNTrainer-style memory-planned training core, ported to PyTorch.

**Entry point:** :func:`repro_torch.core.compile_plan`.  Declare the
network (a :class:`repro_torch.core.graph.LayerGraph` or a transformer
``ModelConfig``) and a :class:`repro_torch.core.MemoryPlanConfig`; one
compile step derives execution order, proactive-swap schedule, swap-aware
arena packing and the remat/offload decisions, iterates the
schedule/planner co-optimisation to a fixed point, verifies the lowered
schedule, and returns a :class:`repro_torch.core.CompiledMemoryPlan`
exposing ``.loss_and_grads()``, ``.peak_bytes`` and ``.report()``.

The planning modules are copies of the reference's (the port imports
nothing of it); the same graph gives the same op list, so the torch
backends replay the very schedule the verifier proved:

* :mod:`repro_torch.core.lifespan`        — tensor lifespans & create modes
* :mod:`repro_torch.core.graph`           — layer-basis graph IR + Realizers
* :mod:`repro_torch.core.execution_order` — Algorithm 1 (EOs + merging)
* :mod:`repro_torch.core.planner`         — Algorithm 2 + the other planners
* :mod:`repro_torch.core.ideal`           — §3 ideal-memory calculator
* :mod:`repro_torch.core.offload`         — EO-driven proactive-swap schedule
* :mod:`repro_torch.core.remat_policy`    — joint keep/recompute/offload
                                            planner (its pure half)
* :mod:`repro_torch.core.plan`            — the compile facade + lowering
* :mod:`repro_torch.core.verify`          — static schedule verifier
* :mod:`repro_torch.core.zoo`             — the paper's model graphs

and in torch:

* :mod:`repro_torch.core.inplace` — derivative-from-output activations
* :mod:`repro_torch.core.exec`    — per-layer math, the activation store
                                    with its transfer engines (the CUDA
                                    copy stream), the replay backends

The reference's deprecated package-level re-exports of the pipeline
stages and its ``planned_exec`` shim are not carried over: import from the
modules above.
"""

from repro_torch.core.exec.backends import (BACKENDS, AsyncDeviceBackend,
                                            ExecutorBackend,
                                            SimulatedBackend, get_backend)
from repro_torch.core.plan import (ArenaBudgetError, CompiledMemoryPlan,
                                   Compute, CooptStats, ExecutionSchedule,
                                   Free, MemoryPlanConfig, Prefetch, SwapOut,
                                   compile_plan, compile_plan_under_budget,
                                   lower_schedule)
from repro_torch.core.planner import PLANNERS, ArenaAllocator, get_planner
from repro_torch.core.remat_policy import (RematPlan, plan_joint_policy,
                                           plan_step_time_s)
from repro_torch.core.verify import (CHECKS, Diagnostic,
                                     ScheduleVerificationError, VerifyReport,
                                     verify_plan, verify_schedule)

__all__ = [
    # the compile API
    "MemoryPlanConfig", "CompiledMemoryPlan", "CooptStats", "compile_plan",
    "compile_plan_under_budget", "ArenaBudgetError",
    # the lowered executor-facing IR
    "ExecutionSchedule", "Compute", "SwapOut", "Prefetch", "Free",
    "lower_schedule",
    # the pluggable allocator layer (device arena + host pool)
    "ArenaAllocator", "PLANNERS", "get_planner",
    # the pluggable executor-backend layer (repro_torch.core.exec)
    "ExecutorBackend", "SimulatedBackend", "AsyncDeviceBackend",
    "BACKENDS", "get_backend",
    # the static schedule verifier (repro_torch.core.verify)
    "CHECKS", "Diagnostic", "VerifyReport", "ScheduleVerificationError",
    "verify_plan", "verify_schedule",
    # the joint keep/recompute/offload planner
    "RematPlan", "plan_joint_policy", "plan_step_time_s",
]
