"""The memory-safety checker passes of :mod:`repro_torch.core.verify`.

The stack's central claim — proactive swapping cuts peak memory *without
sacrificing correctness* — rests on every planner/allocator/lowering
combination emitting a sound schedule.  Until now that soundness was only
sampled at run time (grads vs autograd, high-water assertions); these
passes prove it *before any op executes*, the way On-Device Training
Under 256KB Memory proves its compile-time memory contracts.

A registry of independent checker passes (:data:`CHECKS`, mirroring the
``PLANNERS``/``BACKENDS`` registries) walks the
:class:`repro_torch.core.plan.ExecutionSchedule` together with the packed
:class:`repro_torch.core.planner.Plan` arenas and emits structured
:class:`Diagnostic` records.  The authoritative check-id table lives in
the package docstring (:mod:`repro_torch.core.verify`); the dependence /
fusion-legality prover is :mod:`repro_torch.core.verify.deps`, which joins the
registry as the ``deps`` pass from the package ``__init__``.

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

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import (Any, Callable, Dict, Iterable, List, Optional, Set,
                    Tuple)

from repro_torch.core.execution_order import OrderedTensors
from repro_torch.core.planner import (ALIGN, Plan, Placement, SwapAwarePlan,
                                      _align)

SEV_ERROR = "error"
SEV_WARNING = "warning"


class ScheduleVerificationError(AssertionError):
    """A schedule failed static verification in ``"error"`` mode.

    Subclasses :class:`AssertionError` so call sites that guarded the old
    ``Plan.validate()`` assertions keep catching verifier failures."""

    def __init__(self, diagnostics: Tuple["Diagnostic", ...]):
        self.diagnostics = diagnostics
        lines = [d.render() for d in diagnostics[:8]]
        more = len(diagnostics) - len(lines)
        if more > 0:
            lines.append(f"... and {more} more")
        super().__init__(
            "schedule failed static verification "
            f"({len(diagnostics)} error diagnostic(s)):\n  "
            + "\n  ".join(lines))


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding of a checker pass."""

    severity: str                      # "error" | "warning"
    check: str                         # check id (see module docstring)
    message: str                       # human-readable explanation
    op_index: Optional[int] = None     # index into ExecutionSchedule.ops
    tensor: Optional[str] = None       # tensor the finding is about
    offsets: Tuple[int, ...] = ()      # byte offsets involved

    def render(self) -> str:
        where = "" if self.op_index is None else f" op[{self.op_index}]"
        who = "" if self.tensor is None else f" {self.tensor}"
        return f"[{self.severity}:{self.check}]{where}{who}: {self.message}"


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """What one verifier run proved (or failed to prove)."""

    diagnostics: Tuple[Diagnostic, ...]
    checks_run: Tuple[str, ...]
    ops_scanned: int
    placements_scanned: int
    wall_time_s: float
    # per-pass wall time (check id -> seconds), recorded on BOTH entry
    # points so the cost of each pass — notably the O(T^2) deps sweep —
    # is visible in report()["verify"] / BENCH_swap.json
    check_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors()

    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == SEV_ERROR)

    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == SEV_WARNING)

    def check_ids(self) -> Set[str]:
        return {d.check for d in self.diagnostics}

    def raise_if_errors(self) -> None:
        errs = self.errors()
        if errs:
            raise ScheduleVerificationError(errs)

    def summary(self) -> Dict[str, Any]:
        """The report()["verify"] / BENCH_swap.json row shape."""
        out: Dict[str, Any] = {
            "ok": self.ok,
            "errors": len(self.errors()),
            "warnings": len(self.warnings()),
            "checks_run": list(self.checks_run),
            "ops_scanned": self.ops_scanned,
            "placements_scanned": self.placements_scanned,
            "wall_time_s": self.wall_time_s,
            "check_wall_time_s": dict(self.check_seconds),
        }
        if self.diagnostics:
            out["diagnostics"] = [dataclasses.asdict(d)
                                  for d in self.diagnostics[:20]]
        return out


# ---------------------------------------------------------------------------
# Check context: everything a pass may inspect, derived once
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckContext:
    """One verification subject: the lowered ops plus their plan context."""

    ordered: OrderedTensors
    schedule: Any                      # OffloadSchedule | None
    plan: Any                          # SwapAwarePlan | Plan | None
    ops: Tuple[Any, ...]               # ExecutionSchedule.ops

    # derived fields (populated by build)
    decisions: Dict[str, Any] = dataclasses.field(default_factory=dict)
    activations: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, ordered: OrderedTensors, schedule, plan,
              lowered) -> "CheckContext":
        ctx = cls(ordered=ordered, schedule=schedule, plan=plan,
                  ops=tuple(lowered.ops) if lowered is not None else ())
        if schedule is not None:
            ctx.decisions = {d.name: d for d in schedule.decisions}
        ctx.activations = {
            t.name: t for t in ordered.planned_tensors()
            if t.name.startswith("X:")
        }
        return ctx

    # ------------------------------------------------------------- queries
    @property
    def swap_aware(self) -> bool:
        return isinstance(self.plan, SwapAwarePlan)

    @property
    def device_plan(self) -> Optional[Plan]:
        if self.swap_aware:
            return self.plan.device
        return self.plan if isinstance(self.plan, Plan) else None

    @property
    def host_plan(self) -> Optional[Plan]:
        return self.plan.host if self.swap_aware else None

    def residency_placements(self, name: str) -> Tuple[Placement, ...]:
        """Pre/post device placements for ``name`` (1 entry if unsplit)."""
        if self.swap_aware:
            rs = self.plan.residencies.get(name)
            if rs:
                return tuple(sorted(rs, key=lambda r: r.min_eo))
        dp = self.device_plan
        if dp is not None and name in dp.placements:
            return (dp.placements[name],)
        return ()

    def planned_device_offset(self, name: str, *, post: bool) -> int:
        rs = self.residency_placements(name)
        if not rs:
            return -1
        return rs[-1 if post else 0].offset

    def planned_host_offset(self, name: str) -> int:
        hp = self.host_plan
        if hp is not None:
            p = hp.placements.get(name + "@host")
            if p is not None:
                return p.offset
        return -1

    def aligned_nbytes(self, name: str) -> int:
        t = self.ordered.tensors.get(name)
        return _align(t.nbytes) if t is not None else 0

    def transfer_ops(self, name: str) -> List[Tuple[int, Any]]:
        """(op index, op) of every SwapOut/Prefetch naming ``name``."""
        from repro_torch.core.plan import Prefetch, SwapOut
        return [(i, op) for i, op in enumerate(self.ops)
                if isinstance(op, (SwapOut, Prefetch))
                and op.tensor == name]

    def producer_eo(self, name: str) -> int:
        """The phase producing ``name`` (its first recorded access)."""
        t = self.ordered.tensors.get(name)
        return min(t.exec_orders) if t is not None and t.exec_orders else -1


# ---------------------------------------------------------------------------
# The checker passes
# ---------------------------------------------------------------------------

def check_use_before_resident(ctx: CheckContext) -> List[Diagnostic]:
    """Every recorded access of a planned ``X:`` tensor must land while the
    tensor is device-resident: between production and its ``SwapOut``, or at
    (or after) the ``read_eo`` its ``Prefetch`` guarantees — the static
    analogue of the async backend's consumer fence."""
    from repro_torch.core.plan import Prefetch, SwapOut
    diags: List[Diagnostic] = []
    if not ctx.ops:
        return diags
    for name, t in ctx.activations.items():
        tops = sorted(ctx.transfer_ops(name), key=lambda e: e[1].eo)
        if not tops:
            continue
        for eo in t.exec_orders:
            # the most recent transfer at or before this access decides
            # residency: SwapOut -> gone, Prefetch -> back (readable once
            # the transfer's read_eo deadline passes)
            last = None
            for _, op in tops:
                if op.eo <= eo:
                    last = op
                else:
                    break
            if last is None or isinstance(last, SwapOut):
                if last is not None and eo > last.eo:
                    diags.append(Diagnostic(
                        SEV_ERROR, "use_before_resident",
                        f"read at EO {eo} while swapped out since EO "
                        f"{last.eo} with no prefetch in between",
                        tensor=name))
            elif isinstance(last, Prefetch) and eo < last.read_eo \
                    and eo > last.eo:
                diags.append(Diagnostic(
                    SEV_ERROR, "use_before_resident",
                    f"read at EO {eo} races the in-flight prefetch issued "
                    f"at EO {last.eo} (guaranteed complete only at EO "
                    f"{last.read_eo})", tensor=name))
    return diags


def check_transfer_race(ctx: CheckContext) -> List[Diagnostic]:
    """No transfer may race another: a prefetch must follow its own
    swap-out, host slots of concurrent swap windows must not overlap, and a
    prefetch target must not overlap a still-resident tensor's bytes."""
    from repro_torch.core.plan import Prefetch, SwapOut
    diags: List[Diagnostic] = []

    # (a) per-tensor ordering: the prefetch re-reads what the swap-out
    # wrote, so it must be issued strictly after the swap-out's phase
    per_tensor: Dict[str, Dict[str, Tuple[int, Any]]] = {}
    for i, op in enumerate(ctx.ops):
        if isinstance(op, SwapOut):
            per_tensor.setdefault(op.tensor, {})["out"] = (i, op)
        elif isinstance(op, Prefetch):
            per_tensor.setdefault(op.tensor, {})["in"] = (i, op)
    for name, pair in per_tensor.items():
        if "in" in pair and "out" in pair:
            (oi, out), (pi, pin) = pair["out"], pair["in"]
            if pin.eo <= out.eo:
                diags.append(Diagnostic(
                    SEV_ERROR, "transfer_race",
                    f"prefetch at EO {pin.eo} issued before its swap-out "
                    f"(EO {out.eo}) retired", op_index=pi, tensor=name))
        elif "in" in pair and "out" not in pair:
            pi, pin = pair["in"]
            diags.append(Diagnostic(
                SEV_ERROR, "transfer_race",
                f"prefetch at EO {pin.eo} has no swap-out producing its "
                f"host copy", op_index=pi, tensor=name))

    # (b) host-slot overlap between concurrent swap windows
    windows = []
    for name, pair in per_tensor.items():
        if "in" not in pair or "out" not in pair:
            continue
        _, out = pair["out"]
        _, pin = pair["in"]
        if out.host_offset < 0:
            continue
        windows.append((name, out.eo, pin.read_eo, out.host_offset,
                        out.host_offset + _align(out.nbytes)))
    for i in range(len(windows)):
        for j in range(i + 1, len(windows)):
            a, b = windows[i], windows[j]
            time_overlap = not (a[2] < b[1] or b[2] < a[1])
            byte_overlap = not (a[4] <= b[3] or b[4] <= a[3])
            if time_overlap and byte_overlap:
                diags.append(Diagnostic(
                    SEV_ERROR, "transfer_race",
                    f"host slot [{a[3]},{a[4]}) of {a[0]} overlaps "
                    f"[{b[3]},{b[4]}) of {b[0]} while both swap windows "
                    f"are live", tensor=a[0], offsets=(a[3], b[3])))

    # (c) prefetch target vs still-resident device bytes, simulated over
    # the op list (catches reordered swap-outs the placements cannot see)
    for i, op, resident in _walk_residency(ctx):
        if not isinstance(op, Prefetch) or op.device_offset < 0:
            continue
        lo, hi = op.device_offset, op.device_offset + _align(op.nbytes)
        for other, (ooff, oend) in resident.items():
            if other == op.tensor or ooff < 0:
                continue
            if not (oend <= lo or hi <= ooff):
                diags.append(Diagnostic(
                    SEV_ERROR, "transfer_race",
                    f"prefetch target [{lo},{hi}) overlaps still-resident "
                    f"{other} [{ooff},{oend}) at EO {op.eo}",
                    op_index=i, tensor=op.tensor, offsets=(lo, ooff)))
    return diags


def check_arena_alias(ctx: CheckContext) -> List[Diagnostic]:
    """Interval-overlap sweep over both packed arenas, plus op offset <->
    placement consistency.  Subsumes (and backs) ``Plan.validate()``."""
    from repro_torch.core.plan import Free, Prefetch, SwapOut
    diags: List[Diagnostic] = []
    dp, hp = ctx.device_plan, ctx.host_plan
    if dp is not None:
        diags.extend(d for d in plan_aliasing_diagnostics(dp, "device")
                     if d.check == "arena_alias")
    if hp is not None:
        diags.extend(d for d in plan_aliasing_diagnostics(hp, "host")
                     if d.check == "arena_alias")
    if dp is None:
        return diags
    for i, op in enumerate(ctx.ops):
        if isinstance(op, (SwapOut, Prefetch)):
            post = isinstance(op, Prefetch)
            want = ctx.planned_device_offset(op.tensor, post=post)
            if op.device_offset != want:
                diags.append(Diagnostic(
                    SEV_ERROR, "arena_alias",
                    f"{type(op).__name__} device offset {op.device_offset} "
                    f"diverges from the packed placement ({want})",
                    op_index=i, tensor=op.tensor,
                    offsets=(op.device_offset, want)))
            want_h = ctx.planned_host_offset(op.tensor)
            if op.host_offset != want_h:
                diags.append(Diagnostic(
                    SEV_ERROR, "arena_alias",
                    f"{type(op).__name__} host offset {op.host_offset} "
                    f"diverges from the packed host slot ({want_h})",
                    op_index=i, tensor=op.tensor,
                    offsets=(op.host_offset, want_h)))
        elif isinstance(op, Free):
            want = ctx.planned_device_offset(op.tensor, post=True)
            if op.device_offset != want:
                diags.append(Diagnostic(
                    SEV_ERROR, "arena_alias",
                    f"Free device offset {op.device_offset} diverges from "
                    f"the packed placement ({want})",
                    op_index=i, tensor=op.tensor,
                    offsets=(op.device_offset, want)))
    return diags


def check_heap(ctx: CheckContext) -> List[Diagnostic]:
    """Heap discipline over the op list: swap-outs and frees must pair with
    a live residency, and every planned ``X:`` byte is freed by the end."""
    from repro_torch.core.plan import Compute, Free, Prefetch, SwapOut
    diags: List[Diagnostic] = []
    if not ctx.ops:
        return diags
    produced_at = {name: ctx.producer_eo(name) for name in ctx.activations}
    alive: Set[str] = set()
    hosted: Set[str] = set()
    freed: Set[str] = set()
    for i, op in enumerate(ctx.ops):
        if isinstance(op, Compute):
            if op.kind != "F":
                continue
            owner = ctx.ordered.owner(f"X:{op.layer}")
            if owner in produced_at and produced_at[owner] == op.eo:
                alive.add(owner)
        elif isinstance(op, SwapOut):
            if op.tensor not in alive:
                diags.append(Diagnostic(
                    SEV_ERROR, "double_free",
                    f"swap-out at EO {op.eo} of a tensor with no live "
                    f"device residency", op_index=i, tensor=op.tensor))
            alive.discard(op.tensor)
            hosted.add(op.tensor)
        elif isinstance(op, Prefetch):
            if op.tensor not in hosted and op.tensor not in alive:
                diags.append(Diagnostic(
                    SEV_ERROR, "double_free",
                    f"prefetch at EO {op.eo} of a tensor with no host "
                    f"copy", op_index=i, tensor=op.tensor))
            hosted.discard(op.tensor)
            alive.add(op.tensor)
        elif isinstance(op, Free):
            if op.tensor not in alive and op.tensor not in hosted:
                diags.append(Diagnostic(
                    SEV_ERROR, "double_free",
                    f"free at EO {op.eo} of a tensor with no live "
                    f"residency (double free?)", op_index=i,
                    tensor=op.tensor))
            alive.discard(op.tensor)
            hosted.discard(op.tensor)
            freed.add(op.tensor)
    for name in sorted(set(ctx.activations) - freed):
        diags.append(Diagnostic(
            SEV_ERROR, "leak",
            "no Free op releases this tensor's arena bytes by schedule "
            "end", tensor=name))
    for name in sorted(hosted):
        diags.append(Diagnostic(
            SEV_ERROR, "leak",
            "host-pool copy never retired by schedule end", tensor=name))
    return diags


def check_budget(ctx: CheckContext) -> List[Diagnostic]:
    """Statically simulate the op offsets: the device high-water must stay
    within the packed ``peak_bytes``, host slots within
    ``host_pool_bytes``, and every offset must be ALIGN-aligned."""
    from repro_torch.core.plan import Free, Prefetch, SwapOut
    diags: List[Diagnostic] = []
    dp, hp = ctx.device_plan, ctx.host_plan
    # placement-level bounds + alignment over both packed arenas
    if dp is not None:
        diags.extend(d for d in plan_aliasing_diagnostics(dp, "device")
                     if d.check in ("budget", "alignment"))
    if hp is not None:
        diags.extend(d for d in plan_aliasing_diagnostics(hp, "host")
                     if d.check in ("budget", "alignment"))
    arena = dp.arena_bytes if dp is not None else None
    high = 0
    for op in ctx.ops:
        if isinstance(op, Prefetch) and op.device_offset >= 0:
            high = max(high, op.device_offset + _align(op.nbytes))
    if arena is not None and high > arena:
        diags.append(Diagnostic(
            SEV_ERROR, "budget",
            f"simulated device high-water {high} exceeds the packed arena "
            f"peak {arena}", offsets=(high, arena)))
    if hp is not None:
        for i, op in enumerate(ctx.ops):
            if isinstance(op, SwapOut) and op.host_offset >= 0:
                end = op.host_offset + _align(op.nbytes)
                if end > hp.arena_bytes:
                    diags.append(Diagnostic(
                        SEV_ERROR, "budget",
                        f"host slot end {end} exceeds the packed host pool "
                        f"({hp.arena_bytes} bytes)", op_index=i,
                        tensor=op.tensor, offsets=(op.host_offset,)))
    for i, op in enumerate(ctx.ops):
        if isinstance(op, (SwapOut, Prefetch, Free)):
            for off in (op.device_offset,
                        getattr(op, "host_offset", -1)):
                if off > 0 and off % ALIGN != 0:
                    diags.append(Diagnostic(
                        SEV_ERROR, "alignment",
                        f"offset {off} violates ALIGN={ALIGN}",
                        op_index=i, tensor=op.tensor, offsets=(off,)))
    return diags


def check_inplace_prefetch(ctx: CheckContext) -> List[Diagnostic]:
    """An in-place prefetch moves no data: it must emit no DMA ops, hold no
    host slot, keep a stable offset, and no conflicting writer may touch
    its bytes during the vacated window."""
    diags: List[Diagnostic] = []
    if not ctx.swap_aware:
        return diags
    for name, d in ctx.decisions.items():
        if not d.inplace:
            continue
        for i, op in ctx.transfer_ops(name):
            diags.append(Diagnostic(
                SEV_ERROR, "inplace_prefetch",
                f"in-place prefetch must lower to no DMA ops, found "
                f"{type(op).__name__} at EO {op.eo}", op_index=i,
                tensor=name))
        if ctx.planned_host_offset(name) >= 0:
            diags.append(Diagnostic(
                SEV_ERROR, "inplace_prefetch",
                "in-place prefetch must not hold a host-pool slot",
                tensor=name))
        rs = ctx.residency_placements(name)
        if len(rs) != 2:
            continue
        pre, post = rs
        if pre.offset != post.offset:
            diags.append(Diagnostic(
                SEV_ERROR, "inplace_prefetch",
                f"pre offset {pre.offset} != post offset {post.offset}: "
                f"the bytes cannot have survived in place", tensor=name,
                offsets=(pre.offset, post.offset)))
            continue
        lo, hi = pre.offset, pre.offset + post.nbytes
        for p in ctx.device_plan.placements.values():
            if p is pre or p is post:
                continue
            if p.end <= lo or hi <= p.offset:
                continue
            if p.min_eo < post.min_eo and p.max_eo > pre.max_eo:
                diags.append(Diagnostic(
                    SEV_ERROR, "inplace_prefetch",
                    f"{p.name} writes [{p.offset},{p.end}) inside the "
                    f"vacated window ({pre.max_eo},{post.min_eo}) — the "
                    f"in-place bytes do not survive", tensor=name,
                    offsets=(pre.offset, p.offset)))
    return diags


def check_optim_region(ctx: CheckContext) -> List[Diagnostic]:
    """Optimizer-state transfer ops must replay exactly what the optimizer
    plan packed: offsets match the opt device/host placements, stay inside
    the opt arenas, honour ALIGN, and every slot pairs one ``OptPrefetch``
    with one later ``OptSwapOut`` (the working buffer is read before it is
    re-quantized back out — the reverse of the activation pairing)."""
    from repro_torch.core.plan import OptPrefetch, OptSwapOut
    diags: List[Diagnostic] = []
    opt_ops = [(i, op) for i, op in enumerate(ctx.ops)
               if isinstance(op, (OptPrefetch, OptSwapOut))]
    if not opt_ops:
        return diags
    optim = getattr(ctx.plan, "optim", None)
    if optim is None:
        diags.append(Diagnostic(
            SEV_ERROR, "optim_region",
            f"{len(opt_ops)} optimizer transfer op(s) but the plan carries "
            f"no optimizer plan to validate them against",
            op_index=opt_ops[0][0], tensor=opt_ops[0][1].tensor))
        return diags
    per_tensor: Dict[str, Dict[str, Tuple[int, Any]]] = {}
    for i, op in opt_ops:
        kind = "in" if isinstance(op, OptPrefetch) else "out"
        per_tensor.setdefault(op.tensor, {})[kind] = (i, op)
        # placement consistency: device working buffer + host slot
        dpl = optim.device.placements.get(op.tensor)
        if dpl is None:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                "no packed optimizer device placement for this slot",
                op_index=i, tensor=op.tensor))
            continue
        if op.device_offset != dpl.offset:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                f"{type(op).__name__} device offset {op.device_offset} "
                f"diverges from the packed opt placement ({dpl.offset})",
                op_index=i, tensor=op.tensor,
                offsets=(op.device_offset, dpl.offset)))
        hpl = optim.host.placements.get(op.tensor + "@host")
        if hpl is None:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                "no packed optimizer host slot for this tensor",
                op_index=i, tensor=op.tensor))
            continue
        if op.host_offset != hpl.offset:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                f"{type(op).__name__} host offset {op.host_offset} "
                f"diverges from the packed opt host slot ({hpl.offset})",
                op_index=i, tensor=op.tensor,
                offsets=(op.host_offset, hpl.offset)))
        if op.host_nbytes > hpl.nbytes:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                f"compressed copy ({op.host_nbytes} B) overflows its "
                f"packed host slot ({hpl.nbytes} B)",
                op_index=i, tensor=op.tensor,
                offsets=(op.host_offset,)))
        # bounds + alignment against the *opt* arenas (their own address
        # spaces — never mixed with the activation arenas)
        if op.device_offset + _align(op.nbytes) > optim.device.arena_bytes:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                f"working buffer end "
                f"{op.device_offset + _align(op.nbytes)} exceeds the opt "
                f"device arena ({optim.device.arena_bytes} B)",
                op_index=i, tensor=op.tensor, offsets=(op.device_offset,)))
        if op.host_offset + _align(op.host_nbytes) > optim.host.arena_bytes:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                f"host slot end {op.host_offset + _align(op.host_nbytes)} "
                f"exceeds the opt host pool ({optim.host.arena_bytes} B)",
                op_index=i, tensor=op.tensor, offsets=(op.host_offset,)))
        for off in (op.device_offset, op.host_offset):
            if off > 0 and off % ALIGN != 0:
                diags.append(Diagnostic(
                    SEV_ERROR, "alignment",
                    f"opt offset {off} violates ALIGN={ALIGN}",
                    op_index=i, tensor=op.tensor, offsets=(off,)))
    # pairing: one prefetch strictly before one swap-out per slot
    for name, pair in sorted(per_tensor.items()):
        if "in" not in pair:
            i, _ = pair["out"]
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                "OptSwapOut with no OptPrefetch admitting the working "
                "state it re-quantizes", op_index=i, tensor=name))
        elif "out" not in pair:
            i, _ = pair["in"]
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                "OptPrefetch with no OptSwapOut retiring the working "
                "buffer", op_index=i, tensor=name))
        elif pair["in"][0] > pair["out"][0]:
            diags.append(Diagnostic(
                SEV_ERROR, "optim_region",
                f"OptSwapOut at op[{pair['out'][0]}] precedes its "
                f"OptPrefetch at op[{pair['in'][0]}]: the swap-out would "
                f"re-quantize an unwritten working buffer",
                op_index=pair["out"][0], tensor=name))
    return diags


# The checker registry: independent passes, run in order.  Mirrors the
# PLANNERS / BACKENDS registries — register a new invariant by adding an
# entry; verify_schedule runs every pass (or the caller's subset).
CHECKS: Dict[str, Callable[[CheckContext], List[Diagnostic]]] = {
    "use_before_resident": check_use_before_resident,
    "transfer_race": check_transfer_race,
    "arena_alias": check_arena_alias,
    "heap": check_heap,
    "budget": check_budget,
    "inplace_prefetch": check_inplace_prefetch,
    "optim_region": check_optim_region,
}


# ---------------------------------------------------------------------------
# Shared static simulation
# ---------------------------------------------------------------------------

def _walk_residency(ctx: CheckContext):
    """Walk the op list maintaining the statically known device residency.

    Yields ``(op_index, op, resident)`` where ``resident`` maps each
    device-resident planned ``X:`` tensor to its ``[offset, end)`` byte
    interval *before* the op takes effect.  Production happens at the
    producing layer's F phase; ``SwapOut``/``Free`` evict; ``Prefetch``
    re-admits at the op's target offset.  Tensors without a placement
    (offset < 0) are tracked with a degenerate interval so heap-style
    checks still see them."""
    from repro_torch.core.plan import Compute, Free, Prefetch, SwapOut
    produced_at = {name: ctx.producer_eo(name) for name in ctx.activations}
    resident: Dict[str, Tuple[int, int]] = {}
    for i, op in enumerate(ctx.ops):
        yield i, op, resident
        if isinstance(op, Compute):
            if op.kind != "F":
                continue
            owner = ctx.ordered.owner(f"X:{op.layer}")
            if owner in produced_at and produced_at[owner] == op.eo \
                    and owner not in resident:
                off = ctx.planned_device_offset(owner, post=False)
                end = off + ctx.aligned_nbytes(owner) if off >= 0 else off
                resident[owner] = (off, end)
        elif isinstance(op, SwapOut):
            resident.pop(op.tensor, None)
        elif isinstance(op, Prefetch):
            off = op.device_offset
            end = off + _align(op.nbytes) if off >= 0 else off
            resident[op.tensor] = (off, end)
        elif isinstance(op, Free):
            resident.pop(op.tensor, None)


class StaticResidencyModel:
    """The verifier's residency model, steppable op by op at run time.

    The executor backends' debug sanitizer walks this model alongside the
    real :class:`repro_torch.core.exec.store.ActivationStore` and cross-checks
    that the set of device-resident planned ``X:`` owners matches the
    static prediction after every replayed op — any divergence means the
    runtime wandered off the verified schedule."""

    def __init__(self, ordered: OrderedTensors):
        self.ordered = ordered
        self.resident: Set[str] = set()
        self._produced_at = {
            t.name: (min(t.exec_orders) if t.exec_orders else -1)
            for t in ordered.planned_tensors()
            if t.name.startswith("X:")
        }

    def step(self, op) -> None:
        from repro_torch.core.plan import Compute, Free, Prefetch, SwapOut
        if isinstance(op, Compute):
            if op.kind != "F":
                return
            owner = self.ordered.owner(f"X:{op.layer}")
            if self._produced_at.get(owner) == op.eo:
                self.resident.add(owner)
        elif isinstance(op, SwapOut):
            self.resident.discard(op.tensor)
        elif isinstance(op, Prefetch):
            self.resident.add(op.tensor)
        elif isinstance(op, Free):
            self.resident.discard(op.tensor)

    def cross_check(self, store_alive: Iterable[str], op_index: int) -> None:
        actual = {n for n in store_alive if n in self._produced_at}
        if actual != self.resident:
            missing = sorted(self.resident - actual)
            extra = sorted(actual - self.resident)
            raise AssertionError(
                f"sanitizer: runtime residency diverged from the static "
                f"model after op[{op_index}]: missing={missing} "
                f"extra={extra}")


# ---------------------------------------------------------------------------
# Plan.validate() substrate: the aliasing sweep as diagnostics
# ---------------------------------------------------------------------------

def plan_aliasing_diagnostics(plan: Plan,
                              arena: str = "device") -> List[Diagnostic]:
    """The interval-overlap/bounds/alignment sweep over one packed arena,
    as structured diagnostics.  ``Plan.validate()`` delegates here and
    raises on the first finding, preserving its historical contract."""
    diags: List[Diagnostic] = []
    ps = list(plan.placements.values())
    for i in range(len(ps)):
        for j in range(i + 1, len(ps)):
            a, b = ps[i], ps[j]
            lifetimes_overlap = not (a.max_eo < b.min_eo
                                     or b.max_eo < a.min_eo)
            bytes_overlap = not (a.end <= b.offset or b.end <= a.offset)
            if lifetimes_overlap and bytes_overlap:
                diags.append(Diagnostic(
                    SEV_ERROR, "arena_alias",
                    f"overlap: {a.name} [{a.offset},{a.end}) "
                    f"eo[{a.min_eo},{a.max_eo}] vs {b.name} "
                    f"[{b.offset},{b.end}) eo[{b.min_eo},{b.max_eo}]",
                    tensor=a.name, offsets=(a.offset, b.offset)))
    for p in ps:
        if p.end > plan.arena_bytes:
            diags.append(Diagnostic(
                SEV_ERROR, "budget", f"{p.name} exceeds arena",
                tensor=p.name, offsets=(p.offset,)))
        if p.offset % ALIGN != 0:
            diags.append(Diagnostic(
                SEV_ERROR, "alignment",
                f"{p.name} at offset {p.offset} violates ALIGN={ALIGN}",
                tensor=p.name, offsets=(p.offset,)))
    return diags


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def verify_schedule(ordered: OrderedTensors, schedule, plan, lowered, *,
                    checks: Optional[Iterable[str]] = None) -> VerifyReport:
    """Run the checker registry over one lowered graph-path plan.

    ``checks`` restricts the passes (default: all of :data:`CHECKS`).
    Returns the :class:`VerifyReport`; raising on errors is the caller's
    policy (``MemoryPlanConfig.verify``)."""
    t0 = time.perf_counter()
    ctx = CheckContext.build(ordered, schedule, plan, lowered)
    names = tuple(checks) if checks is not None else tuple(CHECKS)
    diags: List[Diagnostic] = []
    check_seconds: Dict[str, float] = {}
    for name in names:
        try:
            checker = CHECKS[name]
        except KeyError:
            raise ValueError(
                f"unknown verifier check {name!r}: choose from "
                f"{', '.join(sorted(CHECKS))}") from None
        t_pass = time.perf_counter()
        diags.extend(checker(ctx))
        check_seconds[name] = time.perf_counter() - t_pass
    placements = 0
    if ctx.device_plan is not None:
        placements += len(ctx.device_plan.placements)
    if ctx.host_plan is not None:
        placements += len(ctx.host_plan.placements)
    return VerifyReport(
        diagnostics=tuple(diags), checks_run=names,
        ops_scanned=len(ctx.ops), placements_scanned=placements,
        wall_time_s=time.perf_counter() - t0,
        check_seconds=check_seconds)


def verify_model_plan(cp) -> VerifyReport:
    """The model-config path's static contract: the knapsack's kept bytes
    must respect the per-layer HBM budget it was solved under."""
    t0 = time.perf_counter()
    diags: List[Diagnostic] = []
    budget = cp.config.remat_budget_bytes
    if budget is None:
        budget = getattr(cp.model_config, "remat_budget_bytes", None)
    rp = cp.remat_plan
    if rp is not None and budget is not None \
            and rp.saved_bytes_per_layer > budget:
        diags.append(Diagnostic(
            SEV_ERROR, "budget",
            f"kept intermediates ({rp.saved_bytes_per_layer} B/layer) "
            f"exceed the per-layer HBM budget ({budget} B)",
            offsets=(rp.saved_bytes_per_layer, budget)))
    dt = time.perf_counter() - t0
    return VerifyReport(
        diagnostics=tuple(diags), checks_run=("budget",),
        ops_scanned=0, placements_scanned=0,
        wall_time_s=dt, check_seconds={"budget": dt})


def verify_plan(cp, *, checks: Optional[Iterable[str]] = None
                ) -> VerifyReport:
    """Verify a :class:`CompiledMemoryPlan` (either compile path)."""
    if cp.source == "graph":
        return verify_schedule(cp.ordered, cp.schedule, cp.plan,
                               cp.lowered, checks=checks)
    return verify_model_plan(cp)


# ---------------------------------------------------------------------------
# Cross-session interleaving legality
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SessionArenaSlice:
    """One admitted session's claim on the shared device arena.

    The phase-interleaved scheduler (:mod:`repro.serve.scheduler`) runs N
    sessions' plans concurrently over one physical arena; each session's
    plan packs its own offsets from 0 inside a share starting at
    ``base_offset``.  Interleaving is alias-free iff the shares are
    pairwise disjoint intervals and every plan fits inside its share —
    exactly what :func:`verify_interleaving` proves.
    """

    session: str                 # session/user id
    qos: str                     # admission QoS class name
    base_offset: int             # share start in the physical arena
    share_bytes: int             # share size (admission-priced)
    peak_bytes: int              # the session plan's packed device peak

    @property
    def end(self) -> int:
        return self.base_offset + self.share_bytes


def verify_interleaving(slices) -> VerifyReport:
    """Prove N admitted sessions may interleave on one device arena.

    Emits ``cross_session_arena`` diagnostics when any share starts at a
    negative offset, any session's packed peak exceeds its share (its ops
    would write past the share's end), or any two shares' byte intervals
    overlap (one session's swaps would alias another's live activations).
    This check judges the *admission state*, not a single lowered
    schedule, so it lives outside the per-schedule :data:`CHECKS`
    registry — the scheduler runs it over the live slice set before any
    cursor advances, and the mutation harness forges overlapping slices
    against it (class 12).
    """
    t0 = time.perf_counter()
    sl = sorted(slices, key=lambda s: (s.base_offset, s.session))
    diags: List[Diagnostic] = []
    for s in sl:
        if s.base_offset < 0:
            diags.append(Diagnostic(
                SEV_ERROR, "cross_session_arena",
                f"session {s.session!r} ({s.qos}) share starts at negative "
                f"offset {s.base_offset}",
                tensor=s.session, offsets=(s.base_offset,)))
        if s.peak_bytes > s.share_bytes:
            diags.append(Diagnostic(
                SEV_ERROR, "cross_session_arena",
                f"session {s.session!r} ({s.qos}) plan peak "
                f"{s.peak_bytes} B exceeds its arena share "
                f"{s.share_bytes} B",
                tensor=s.session,
                offsets=(s.base_offset, s.peak_bytes, s.share_bytes)))
    for a, b in zip(sl, sl[1:]):
        if b.base_offset < a.end:
            diags.append(Diagnostic(
                SEV_ERROR, "cross_session_arena",
                f"arena shares overlap: {a.session!r} ({a.qos}) "
                f"[{a.base_offset},{a.end}) vs {b.session!r} ({b.qos}) "
                f"[{b.base_offset},{b.end})",
                tensor=a.session,
                offsets=(a.base_offset, a.end, b.base_offset, b.end)))
    dt = time.perf_counter() - t0
    return VerifyReport(
        diagnostics=tuple(diags), checks_run=("cross_session_arena",),
        ops_scanned=0, placements_scanned=len(sl),
        wall_time_s=dt, check_seconds={"cross_session_arena": dt})


# ---------------------------------------------------------------------------
# Verified-schedule registry (the backends' admission check)
# ---------------------------------------------------------------------------

# Schedules that passed verification with zero errors.  Executor backends
# consult this before replaying: an unverified schedule is verified on the
# spot and refused if unsound (see _ReplayBackend.run).  Keyed by object
# identity (frozen dataclasses compare by value, and a verdict belongs to
# the exact compiled object, not to look-alikes); weak values, so a
# schedule's entry dies with the schedule.
_VERIFIED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def mark_verified(lowered) -> None:
    _VERIFIED[id(lowered)] = lowered


def is_verified(lowered) -> bool:
    return _VERIFIED.get(id(lowered)) is lowered
