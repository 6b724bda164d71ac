#!/usr/bin/env python
"""Mutation harness of the port: forge corrupted schedules, prove the
port's verifier catches each one.

The port's counterpart of ``tools/mutate_schedule.py``, over
``repro_torch.core``: the same reference plan, the same twelve corruption
classes, and each must be flagged with the same check id as the
reference's harness reports for the same forgery.

The static verifier (``repro_torch.core.verify``) is only worth trusting if its
false-negative rate is measured: a checker that never fires also "passes"
every plan.  This harness compiles a known-good reference plan, applies
one corruption per class — the planner-bug shapes the verifier exists to
catch — and asserts every class is flagged *with the expected check id*:

==================  =======================  ==========================
mutation class      forged corruption        expected check id
==================  =======================  ==========================
shift_offset        prefetch lands at the    arena_alias
                    wrong arena offset
drop_prefetch       swap-out with no         use_before_resident
                    matching prefetch
reorder_swap_out    swap-out retires after   transfer_race
                    its prefetch issued
double_free         one Free replayed twice  double_free
truncate_free       one Free dropped         leak
budget_overflow     prefetch target beyond   budget
                    the packed arena peak
misalign            offset off the ALIGN     alignment
                    grid
corrupt_opt_offset  OptPrefetch working      optim_region
                    buffer off its packed
                    opt-arena slot
hoist_compute       Compute hoisted before   dep_transfer_fence
                    the Prefetch feeding it
drop_dep_edge       SwapOut permuted ahead   dep_edge
                    of its producing Compute
fuse_across_swap    forged FusedBlock        fusion_fence
                    spanning a SwapOut
overlap_arena_      two sessions' arena      cross_session_arena
shares              shares alias
==================  =======================  ==========================

The first eight corrupt op *metadata* (offsets, phases, multiset) with
positions intact — the residency/aliasing checkers' beat
(``corrupt_opt_offset`` targets the optimizer-offload lane: the reference
plan compiles with ``optim_offload=True`` so its schedule carries real
``OptPrefetch``/``OptSwapOut`` ops).  The last three
corrupt op *positions* (or a fusion plan) with metadata intact — the
dependence prover's beat (``repro_torch.core.verify.deps``): a checker suite
blind to either axis would pass one of the two families.
``fuse_across_swap`` forges a :class:`FusionPlan` rather than an op list,
so it is judged by ``verify_fusion`` instead of ``verify_schedule``.
``overlap_arena_shares`` corrupts neither axis of one schedule: it forges
the *admission-time* per-session arena partition the phase-interleaved
scheduler trusts (two sessions' base offsets overlapping), so it is
judged by ``verify_interleaving`` — the cross-session aliasing prover
every other checker is structurally blind to (they each see one session's
private offsets, which remain individually clean).

Run as a script (CI gate: exits non-zero on any missed corruption) or
import ``mutations`` / ``forge`` / ``run_all`` from tests.
"""

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import MemoryPlanConfig, compile_plan   # noqa: E402
from repro_torch.core.plan import (Compute, ExecutionSchedule,  # noqa: E402
                                   Free, OptPrefetch, Prefetch, SwapOut)
from repro_torch.core.planner import ALIGN  # noqa: E402
from repro_torch.core.verify import (FusedBlock, FusionPlan,  # noqa: E402
                                     SessionArenaSlice, verify_fusion,
                                     verify_interleaving, verify_schedule)
from repro_torch.core.zoo import ZOO  # noqa: E402


def _first(ops, kind):
    for op in ops:
        if isinstance(op, kind):
            return op
    raise AssertionError(
        f"reference schedule has no {kind.__name__} op — pick a config "
        f"that actually swaps")


def _replace_op(ops, old, new):
    return tuple(new if op is old else op for op in ops)


def mutate_shift_offset(ops):
    """Prefetch lands ALIGN*2 bytes away from its packed placement."""
    p = _first(ops, Prefetch)
    return _replace_op(ops, p, dataclasses.replace(
        p, device_offset=p.device_offset + 2 * ALIGN))


def mutate_drop_prefetch(ops):
    """The swap-out stays; the prefetch bringing the bytes back is gone."""
    p = _first(ops, Prefetch)
    return tuple(op for op in ops if op is not p)


def mutate_reorder_swap_out(ops):
    """The swap-out is delayed past its own prefetch's issue phase."""
    p = _first(ops, Prefetch)
    out = next(o for o in ops
               if type(o).__name__ == "SwapOut" and o.tensor == p.tensor)
    return _replace_op(ops, out, dataclasses.replace(out, eo=p.eo + 1))


def mutate_double_free(ops):
    """One Free op replayed twice — the second frees dead bytes."""
    f = _first(ops, Free)
    return tuple(ops) + (f,)


def mutate_truncate_free(ops):
    """One Free op dropped — its arena bytes are never released."""
    f = _first(ops, Free)
    return tuple(op for op in ops if op is not f)


def mutate_budget_overflow(arena_bytes):
    def apply(ops):
        """Prefetch target past the packed arena peak (still aligned)."""
        p = _first(ops, Prefetch)
        beyond = (arena_bytes // ALIGN + 1) * ALIGN
        return _replace_op(ops, p,
                           dataclasses.replace(p, device_offset=beyond))
    return apply


def mutate_misalign(ops):
    """Prefetch offset knocked off the ALIGN grid."""
    p = _first(ops, Prefetch)
    return _replace_op(ops, p, dataclasses.replace(
        p, device_offset=p.device_offset + 3))


def mutate_opt_offset(ops):
    """OptPrefetch working buffer lands off its packed opt-arena slot.

    The optimizer slots pack into their *own* device region, so the
    activation-arena checkers (arena_alias walks ``X:`` placements) are
    structurally blind to this — only ``check_optim_region``'s
    op<->opt-placement comparison can fire."""
    p = _first(ops, OptPrefetch)
    return _replace_op(ops, p, dataclasses.replace(
        p, device_offset=p.device_offset + 2 * ALIGN))


def mutate_hoist_compute(ops):
    """A Compute hoisted before the Prefetch feeding it.

    Phase metadata is untouched — every eo/offset/nbytes field still
    reads like the clean schedule — only the op's *position* moves, so
    the residency checkers (which walk metadata) stay silent and the
    dependence prover's fence edge (Prefetch -> Compute at its read
    phase) is the one that must fire."""
    p = _first(ops, Prefetch)
    pi = ops.index(p)
    c = next(o for o in ops if isinstance(o, Compute) and o.eo == p.read_eo)
    rest = [o for o in ops if o is not c]
    rest.insert(pi, c)          # lands just before the Prefetch feeding it
    return tuple(rest)


def mutate_drop_dep_edge(ops):
    """A SwapOut permuted to the list front, ahead of its producing
    Compute — a dependence-edge-dropping permutation (same op multiset,
    one data edge inverted)."""
    out = _first(ops, SwapOut)
    return (out,) + tuple(o for o in ops if o is not out)


def forge_illegal_fusion(cp) -> FusionPlan:
    """A forged FusedBlock spanning a SwapOut of one of its inputs.

    ``plan_fusion`` would never emit this — blocks split at every
    transfer — so it exercises :func:`verify_fusion`'s independent
    re-proof: the SwapOut inside the block span must be flagged as
    ``fusion_fence``."""
    ops = cp.lowered.ops
    si = ops.index(_first(ops, SwapOut))
    before = max(i for i in range(si) if isinstance(ops[i], Compute))
    after = min(i for i in range(si + 1, len(ops))
                if isinstance(ops[i], Compute))
    block = FusedBlock(index=0, op_indices=(before, si, after),
                       compute_indices=(before, after), free_indices=())
    return FusionPlan(blocks=(block,), n_ops=len(ops),
                      n_computes=sum(isinstance(o, Compute) for o in ops),
                      fence_splits=0, hazard_splits=0, inplace_splits=0,
                      peak_splits=0)


def reference_plan(model: str = "lenet5"):
    """A known-good compiled plan with real data-moving swaps."""
    cp = compile_plan(
        ZOO[model](),
        MemoryPlanConfig(planner="bestfit", host_planner="segregated",
                         min_idle_phases=3, min_bytes=1 << 12,
                         cooptimize=False, optim_offload=True),
        batch=8)
    assert cp.lowered.transfers(), "reference plan must move data"
    assert any(isinstance(op, OptPrefetch) for op in cp.lowered.ops), \
        "reference plan must carry optimizer-offload ops"
    return cp


def mutations(cp):
    """mutation class -> (expected check id, op-list transform)."""
    return {
        "shift_offset": ("arena_alias", mutate_shift_offset),
        "drop_prefetch": ("use_before_resident", mutate_drop_prefetch),
        "reorder_swap_out": ("transfer_race", mutate_reorder_swap_out),
        "double_free": ("double_free", mutate_double_free),
        "truncate_free": ("leak", mutate_truncate_free),
        "budget_overflow": ("budget",
                            mutate_budget_overflow(cp.plan.arena_bytes)),
        "misalign": ("alignment", mutate_misalign),
        "corrupt_opt_offset": ("optim_region", mutate_opt_offset),
        "hoist_compute": ("dep_transfer_fence", mutate_hoist_compute),
        "drop_dep_edge": ("dep_edge", mutate_drop_dep_edge),
    }


# Fusion-plan corruption classes: judged by verify_fusion, not
# verify_schedule — forge() does not apply (there is no op list to forge).
FUSION_MUTATIONS = {
    "fuse_across_swap": ("fusion_fence", forge_illegal_fusion),
}


def forge_overlapping_shares(cp):
    """Two sessions' arena shares overlapping — the admission bug the
    phase-interleaved scheduler would otherwise silently trust.

    Each forged session's *own* plan is the clean reference plan (every
    per-schedule checker passes), and each peak fits its share — only the
    partition is corrupt: session b's base offset starts inside session
    a's share, so a's swap traffic would land in b's live arena bytes.
    ``verify_interleaving`` must flag the pair (``cross_session_arena``)."""
    share = cp.peak_bytes + cp.optim_device_bytes
    return [
        SessionArenaSlice(session="a", qos="standard", base_offset=0,
                          share_bytes=share, peak_bytes=cp.peak_bytes),
        SessionArenaSlice(session="b", qos="standard",
                          base_offset=share // 2,   # inside a's share
                          share_bytes=share, peak_bytes=cp.peak_bytes),
    ]


# Cross-session corruption classes: judged by verify_interleaving over
# forged per-session arena slices — there is no single op list to forge.
INTERLEAVE_MUTATIONS = {
    "overlap_arena_shares": ("cross_session_arena", forge_overlapping_shares),
}


def forge(cp, name: str) -> ExecutionSchedule:
    """Apply one named corruption to ``cp``'s lowered op list."""
    _, fn = mutations(cp)[name]
    return ExecutionSchedule(ops=fn(cp.lowered.ops))


def run_all(cp) -> dict:
    """mutation class -> (expected check id, the check ids reported,
    caught) for every class: the op-list, fusion and interleaving
    forgeries."""
    out = {}
    for name, (expected, _) in mutations(cp).items():
        report = verify_schedule(cp.ordered, cp.schedule, cp.plan,
                                 forge(cp, name))
        got = sorted(report.check_ids())
        out[name] = (expected, got, expected in got and not report.ok)
    for name, (expected, forge_fn) in FUSION_MUTATIONS.items():
        diags = verify_fusion(forge_fn(cp), cp.lowered, cp.ordered, cp.plan)
        got = sorted({d.check for d in diags})
        out[name] = (expected, got, expected in got and any(
            d.severity == "error" for d in diags))
    for name, (expected, forge_fn) in INTERLEAVE_MUTATIONS.items():
        report = verify_interleaving(forge_fn(cp))
        got = sorted(report.check_ids())
        out[name] = (expected, got, expected in got and not report.ok)
    return out


def main() -> int:
    cp = reference_plan()
    clean = verify_schedule(cp.ordered, cp.schedule, cp.plan, cp.lowered)
    if not clean.ok:
        print("FAIL reference plan is not clean:")
        for d in clean.errors():
            print(" ", d.render())
        return 1
    print(f"reference plan clean: {clean.ops_scanned} ops, "
          f"{len(clean.checks_run)} checks")

    missed = 0
    for name, (expected, got, caught) in run_all(cp).items():
        status = "caught" if caught else "MISSED"
        print(f"{status:>7} {name}: expected={expected} got={got}")
        missed += not caught
    if missed:
        print(f"FAIL {missed} corruption class(es) escaped the verifier")
        return 1
    print("all corruption classes caught with the expected check id")
    return 0


if __name__ == "__main__":
    sys.exit(main())
