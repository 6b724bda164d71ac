"""Static plan verifier: prove memory-safety *and* order-equivalence of a
lowered ExecutionSchedule.

The stack's central claim — proactive swapping cuts peak memory *without
sacrificing correctness* — rests on every planner/allocator/lowering
combination emitting a sound schedule.  Until now that soundness was only
sampled at run time (grads vs autograd, high-water assertions); this
package proves it *before any op executes*, the way On-Device Training
Under 256KB Memory proves its compile-time memory contracts.

A registry of independent checker passes (:data:`CHECKS`, mirroring the
``PLANNERS``/``BACKENDS`` registries) walks the
:class:`repro_torch.core.plan.ExecutionSchedule` together with the packed
:class:`repro_torch.core.planner.Plan` arenas and emits structured
:class:`Diagnostic` records.  The passes and the check ids they emit:

======================  =====================================================
registry pass           invariant proven (check ids emitted)
======================  =====================================================
``use_before_resident`` every access of a planned ``X:`` tensor is covered
                        by its producing phase or a completed ``Prefetch`` —
                        the static analogue of the async backend's consumer
                        fence (``use_before_resident``)
``transfer_race``       no ``Prefetch`` is issued before its ``SwapOut``
                        retired, no two host slots overlap while both swap
                        windows are live, and no prefetch target overlaps a
                        still-resident tensor's device bytes
                        (``transfer_race``)
``arena_alias``         interval-overlap sweep over the device arena *and*
                        the host pool, plus op<->placement offset
                        consistency — subsumes ``Plan.validate()``
                        (``arena_alias``)
``heap``                every ``SwapOut``/``Free`` pairs with a live
                        residency and all heap bytes are freed by schedule
                        end (``double_free``, ``leak``)
``budget``              the high-water of the statically simulated offsets
                        stays within the packed ``peak_bytes`` /
                        ``host_pool_bytes`` and every offset is
                        ALIGN-aligned (``budget``, ``alignment``)
``inplace_prefetch``    an in-place prefetch moves no data (no DMA ops) and
                        no conflicting writer touched its bytes in the
                        vacated window (``inplace_prefetch``)
``optim_region``        optimizer-state transfers replay the optimizer
                        plan's packed offsets, stay inside the opt
                        device/host arenas, honour ALIGN, and every slot
                        pairs one ``OptPrefetch`` with one later
                        ``OptSwapOut`` (``optim_region``, ``alignment``)
``deps``                the op list is a linear extension of its own
                        happens-before dependence DAG (:mod:`.deps`): every
                        data / arena-reuse edge respected (``dep_edge``),
                        every transfer fence respected
                        (``dep_transfer_fence``), op multiset intact
                        (``dep_stream``)
======================  =====================================================

:mod:`repro_torch.core.verify.deps` additionally proves *fusion legality*: a
:class:`FusionPlan` produced by :func:`plan_fusion` may only group
``Compute`` runs that cross no transfer fence (``fusion_fence``), defer no
``Free`` whose bytes a later producer in the block reuses and span no
in-place-prefetch window edge (``fusion_hazard``), and never push deferred
residency past the packed peak (``fusion_peak``).
:func:`schedules_equivalent` proves a permuted or fused replay stream
preserves every dependence edge of the verifier-signed original — the
admission gate of the ``jit_blocks`` executor backend.

Entry points: :func:`verify_plan` (a :class:`CompiledMemoryPlan`, either
path), :func:`verify_schedule` (raw graph-path pieces).  ``compile_plan``
runs the verifier according to ``MemoryPlanConfig.verify``
(``"error"|"warn"|"off"``) and folds the report into
``CompiledMemoryPlan.report()["verify"]``; executor backends refuse to
replay a schedule that has not been verified (see
:func:`mark_verified` / :func:`is_verified`), and their debug sanitizer
mode cross-checks runtime residency against :class:`StaticResidencyModel`
op by op.
"""

from repro_torch.core.verify.checks import (CHECKS, SEV_ERROR, SEV_WARNING,
                                            CheckContext, Diagnostic,
                                            ScheduleVerificationError, VerifyReport,
                                            SessionArenaSlice,
                                            StaticResidencyModel, _walk_residency,
                                            check_arena_alias, check_budget,
                                            check_heap, check_inplace_prefetch,
                                            check_optim_region,
                                            check_transfer_race,
                                            check_use_before_resident, is_verified,
                                            mark_verified,
                                            plan_aliasing_diagnostics,
                                            verify_interleaving, verify_model_plan,
                                            verify_plan, verify_schedule)
from repro_torch.core.verify.deps import (DepEdge, DependenceGraph, FusedBlock,
                                          FusionPlan, build_dependence_graph,
                                          check_deps, deps_summary, plan_fusion,
                                          replay_stream, schedules_equivalent,
                                          transfer_slack, verify_fusion)

# The deps pass joins the registry here (not in checks.py) so the module
# split stays acyclic: deps.py builds on checks.py's Diagnostic machinery.
CHECKS.setdefault("deps", check_deps)

__all__ = [
    "CHECKS",
    "SEV_ERROR",
    "SEV_WARNING",
    "CheckContext",
    "DepEdge",
    "DependenceGraph",
    "Diagnostic",
    "FusedBlock",
    "FusionPlan",
    "ScheduleVerificationError",
    "SessionArenaSlice",
    "StaticResidencyModel",
    "VerifyReport",
    "build_dependence_graph",
    "check_arena_alias",
    "check_budget",
    "check_deps",
    "check_heap",
    "check_inplace_prefetch",
    "check_optim_region",
    "check_transfer_race",
    "check_use_before_resident",
    "deps_summary",
    "is_verified",
    "mark_verified",
    "plan_aliasing_diagnostics",
    "plan_fusion",
    "replay_stream",
    "schedules_equivalent",
    "transfer_slack",
    "verify_fusion",
    "verify_interleaving",
    "verify_model_plan",
    "verify_plan",
    "verify_schedule",
]
