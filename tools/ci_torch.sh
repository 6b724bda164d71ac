#!/usr/bin/env bash
# The port's CI gate (src/repro_torch): its half of tools/ci.sh.
#
#     tools/ci_torch.sh [--device cuda] [pytest args...]
#
# Runs on the CPU by default; --device cuda runs the smokes on the card
# (the pytest step always runs the CPU tests; the card's own tests are
# `pytest -m cuda tests/test_torch_cuda*.py`, run on the card).  Extra
# arguments go to pytest, e.g. `tools/ci_torch.sh -n 6` with xdist.
#
# The steps of tools/ci.sh that write and check results/BENCH_swap.json
# (`python -m benchmarks.run ...`) have no counterpart here: the paper's
# benchmarks are ported with the port's first benchmark definition.
set -euo pipefail
cd "$(dirname "$0")/.."

DEVICE=cpu
if [[ "${1:-}" == "--device" ]]; then
    DEVICE="$2"
    shift 2
fi
export CI_TORCH_DEVICE="$DEVICE"
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

# invariant lint: no repro_torch call site may reach a backend's run() or
# start() without verify admission, and the admitted modules keep their
# tripwires
python tools/lint_invariants_torch.py

python -m pytest -q -m "not slow" tests/test_torch_*.py "$@"

# compile_plan smoke: the facade takes a zoo model from graph to a
# validated, co-optimised plan (peak <= no-swap baseline) in one call.
# allocator-layer smoke: lenet5 compiled with every host_planner; the
# replay equals the lowered op list, within both planned high waters.
# backend gate: every registered backend runs the plan end to end, agrees
# on transfer accounting, and matches autograd (reference_loss_and_grads).
# model-config joint-plan smoke: a tight budget forces evictions down both
# priced lanes, with the DMA visible end to end.
python - <<'EOF'
import os
from collections import Counter

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import MemoryPlanConfig, compile_plan, plan_step_time_s
from repro_torch.core.exec import BACKENDS
from repro_torch.core.exec.layers import reference_loss_and_grads
from repro_torch.core.remat_policy import transformer_intermediates
from repro_torch.core.verify import schedules_equivalent
from repro_torch.core.zoo import ZOO
from repro_torch.device import resolve_device

dev = resolve_device(os.environ["CI_TORCH_DEVICE"])

for name in ("lenet5", "resnet18"):
    cp = compile_plan(ZOO[name](),
                      MemoryPlanConfig(min_idle_phases=3, min_bytes=1 << 12),
                      batch=8)
    cp.plan.validate()
    assert cp.peak_bytes <= cp.baseline.arena_bytes, name
    assert cp.peak_bytes <= cp.coopt.single_pass_peak_bytes, name
    print(f"compile_plan smoke {name}: peak={cp.peak_bytes} "
          f"base={cp.baseline.arena_bytes} swaps={len(cp.swapped_names())} "
          f"dropped={len(cp.coopt.dropped)}")

g = ZOO["lenet5"]()
gen = torch.Generator(dev).manual_seed(1)
x = torch.randn((8,) + tuple(g.input_shape), generator=gen, device=dev)
y = torch.nn.functional.one_hot(torch.arange(8, device=dev) % 10,
                                10).float()
params = None
for hp in ("sorting", "bestfit", "segregated", "buddy"):
    cp = compile_plan(g, MemoryPlanConfig(planner="bestfit", host_planner=hp,
                                          min_idle_phases=3,
                                          min_bytes=1 << 12), batch=8)
    cp.plan.validate()
    params = cp.init_params(torch.Generator(dev).manual_seed(0), device=dev)
    _, _, stats = cp.loss_and_grads(params, x, y)
    assert stats.replayed_ops == cp.lowered.ops, \
        f"host_planner={hp}: executor replay diverged from compiled schedule"
    assert stats.late_swap_ins == 0, hp
    assert stats.hbm_high_water <= stats.planned_peak, hp
    assert stats.host_high_water <= cp.host_pool_bytes, hp
    print(f"exec-schedule smoke lenet5/{hp}: "
          f"ops={cp.lowered.counts()} host={cp.host_pool_bytes} "
          f"host_hw={stats.host_high_water} "
          f"inplace={cp.inplace_prefetch_count}")

_, grads_ref = reference_loss_and_grads(g, params, x, y)
per_backend = {}
for ex in sorted(BACKENDS):
    cp = compile_plan(g, MemoryPlanConfig(min_idle_phases=3,
                                          min_bytes=1 << 12, executor=ex),
                      batch=8)
    _, grads, stats = cp.loss_and_grads(params, x, y)
    assert stats.backend == ex
    if ex == "jit_blocks":
        assert Counter(stats.replayed_ops) == Counter(cp.lowered.ops), \
            "executor=jit_blocks: replayed op multiset diverged"
        schedules_equivalent(cp.lowered, stats.replayed_ops,
                             ordered=cp.ordered,
                             plan=cp.plan).raise_if_errors()
        assert stats.dispatch_calls < len(cp.lowered.ops), \
            "jit_blocks must fuse at least one block"
    else:
        assert stats.replayed_ops == cp.lowered.ops, \
            f"executor={ex}: replay diverged from compiled schedule"
        assert stats.dispatch_calls == len(stats.replayed_ops), ex
    assert stats.late_swap_ins == 0, ex
    assert stats.host_high_water <= cp.host_pool_bytes, ex
    for layer, entry in grads_ref.items():
        for k, want in entry.items():
            torch.testing.assert_close(grads[layer][k], want,
                                       rtol=1e-4, atol=1e-5)
    per_backend[ex] = stats
    extra = ""
    if ex == "async":
        assert stats.achieved_overlap is not None
        assert 0 < stats.inflight_high_water \
            <= cp.schedule.peak_inflight_prefetch
        extra = (f" overlap={stats.achieved_overlap:.2f}"
                 f" inflight_hw={stats.inflight_high_water}"
                 f"/{cp.schedule.peak_inflight_prefetch}")
    if ex == "jit_blocks":
        extra = f" dispatch={stats.dispatch_calls}/{len(cp.lowered.ops)}"
    print(f"backend gate lenet5/{ex} on {dev}: dma={stats.dma_bytes} "
          f"swaps={stats.swap_outs}/{stats.prefetches}{extra}")
# all backends executed the same schedule: identical transfer accounting
for ex in sorted(set(BACKENDS) - {"sim"}):
    assert per_backend["sim"].dma_bytes == per_backend[ex].dma_bytes, ex
    assert per_backend["sim"].host_high_water \
        == per_backend[ex].host_high_water, ex

cfg = ARCHS["llama3.2-3b"]
hw = {"dma_gbps": 80.0, "device_tflops": 200.0}
inter = transformer_intermediates(
    batch_tokens=2048, d_model=cfg.d_model, d_ff=cfg.d_ff,
    n_q_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)
cp = compile_plan(cfg, MemoryPlanConfig(remat=True,
                                        remat_budget_bytes=1 << 20,
                                        offload=True, **hw),
                  batch_tokens=2048)
r = cp.report()
assert cp.remat_plan.dropped and cp.remat_plan.offloaded, \
    "joint plan must mix lanes"
assert cp.dma_bytes == r["offload_dma_bytes_per_layer"] * cfg.n_layers > 0
assert r["recompute_flops_per_layer"] > 0
pure = compile_plan(cfg, MemoryPlanConfig(remat=True,
                                          remat_budget_bytes=1 << 20,
                                          offload=False), batch_tokens=2048)
assert (plan_step_time_s(cp.remat_plan, inter, **hw)
        < plan_step_time_s(pure.remat_plan, inter, **hw))
print(f"compile_plan smoke {cfg.name}: decisions={r['remat_decisions']} "
      f"dma={cp.dma_bytes} est={r['est_step_time_s_per_layer']:.6f}s/layer")
EOF

# static-verifier gate (1/2): the whole zoo x device planner x host
# planner sweep compiles with verify="error": every lowered schedule passes
# every registered check with zero diagnostics
python - <<'EOF'
from repro_torch.core import MemoryPlanConfig, compile_plan
from repro_torch.core.verify import CHECKS
from repro_torch.core.zoo import ZOO

ops = placements = 0
for name in sorted(ZOO):
    for planner in ("sorting", "bestfit", "segregated", "buddy"):
        for hp in ("sorting", "segregated"):
            cp = compile_plan(
                ZOO[name](),
                MemoryPlanConfig(planner=planner, host_planner=hp,
                                 min_idle_phases=3, min_bytes=1 << 12,
                                 cooptimize=False, verify="error"),
                batch=4)
            r = cp.verify_report
            assert r.ok, (name, planner, hp)
            assert set(r.checks_run) == set(CHECKS), (name, planner, hp)
            ops += r.ops_scanned
            placements += r.placements_scanned
print(f"verify sweep clean: {len(ZOO)} models x 4 planners x 2 host "
      f"planners, {ops} ops / {placements} placements scanned, "
      f"checks={sorted(CHECKS)}")
EOF

# static-verifier gate (2/2): one forged corruption per class, each
# flagged with the expected check id
python tools/torch_mutate_schedule.py

# serving smoke: 2 buckets x 4 users on lenet5 through the multi-tenant
# PersonalizationService: every request completes, plans are shared across
# tenants, every session's peak stays inside its arena share, no deadlock
python - <<'EOF'
import os

from repro_torch.core.zoo import ZOO
from repro_torch.serve import PersonalizationService
from repro_torch.serve.buckets import dummy_batch

dev = os.environ["CI_TORCH_DEVICE"]
USERS, BUCKETS = 4, (8, 16)
g = ZOO["lenet5"]()
svc = PersonalizationService(g, buckets=BUCKETS, max_live_sessions=USERS,
                             device=dev)
svc.warmup()
for u in range(USERS):
    n = 5 if u % 2 else 12     # both buckets, both padded
    res = svc.submit(f"u{u}", *dummy_batch(g, n, seed=u, device=dev))
    assert res.ok, (u, res.status, res.reason)
    assert res.peak_bytes <= res.arena_share_bytes, u
rep = svc.report()
assert rep["serve"]["completed"] == USERS
assert rep["serve"]["deadlocks"] == 0, "admission deadlock detected"
assert rep["plan_cache"]["hits"] >= USERS - len(BUCKETS), rep["plan_cache"]
assert rep["plan_cache"]["entries"] == len(BUCKETS)
print(f"serving smoke on {dev}: {USERS} users over {len(BUCKETS)} buckets, "
      f"cache={rep['plan_cache']['hits']}h/{rep['plan_cache']['misses']}m, "
      f"share={rep['admission']['arena_share_bytes']}B, deadlocks=0")
EOF
echo "ci_torch: every gate passed ($DEVICE)"
