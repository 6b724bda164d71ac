"""Port parity of the planning half of the paper's path: the port's copies
of graph / execution_order / offload / planner / plan / verify give the
same execution orders, swap decisions, lowered op lists, plan sizes and
verifier summaries as the reference, for every zoo graph (at the zoo's own
widths: planning does no arithmetic on the data) and the llama3.2-3b MLP
trunk cut to 2 layers of 64 -> 128, under each config and planner."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.core.execution_order import \
    compute_execution_order as j_eo  # noqa: E402
from repro.core.planner import PLANNERS as JPLANNERS  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.execution_order import \
    compute_execution_order as t_eo  # noqa: E402
from repro_torch.core.ideal import ideal_memory as t_ideal  # noqa: E402
from repro_torch.core.planner import PLANNERS  # noqa: E402
from repro.core.ideal import ideal_memory as j_ideal  # noqa: E402

torch.set_num_threads(1)

GRAPHS = sorted(tzoo.ZOO) + ["trunk"]
BATCH = 4

# the configs of the reference's plan tests: default, swap-forcing (the
# executor tests' EXEC_CFG), no co-optimisation, and an HBM reclaim budget
CONFIGS = {
    "default": {},
    "swap": dict(min_idle_phases=3, min_bytes=1 << 12),
    "no_coopt": dict(min_idle_phases=3, min_bytes=1 << 12, cooptimize=False),
    "budget": dict(min_idle_phases=3, min_bytes=1 << 12,
                   hbm_budget_bytes=1 << 16),
    "no_swap": dict(swap=False),
}


def _graph(pkg, name):
    if name == "trunk":
        return pkg.transformer_mlp_stack(n_layers=2, d_model=64, d_ff=128)
    return pkg.ZOO[name]()


def _ops(ops):
    return [(type(op).__name__, dataclasses.astuple(op)) for op in ops]


def _untimed(obj):
    """``obj`` without its wall-clock entries (they differ run to run)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if "wall_time" not in k}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_untimed(v) for v in obj)
    return obj


def _eo_table(ordered):
    return (dict(ordered.layer_orders), dict(ordered.merged), ordered.eo_max,
            {n: (t.nbytes, t.lifespan.name, t.create_mode.name,
                 sorted(t.exec_orders), t.merged_into, t.view_of)
             for n, t in ordered.tensors.items()})


def _compiled(name, **knobs):
    jcp = jplan.compile_plan(_graph(jzoo, name),
                             jplan.MemoryPlanConfig(**knobs), batch=BATCH)
    tcp = tplan.compile_plan(_graph(tzoo, name),
                             tplan.MemoryPlanConfig(**knobs), batch=BATCH)
    return jcp, tcp


def _assert_same_plan(jcp, tcp):
    assert _eo_table(tcp.ordered) == _eo_table(jcp.ordered)
    assert [dataclasses.astuple(d) for d in tcp.schedule.decisions] == \
        [dataclasses.astuple(d) for d in jcp.schedule.decisions]
    assert _ops(tcp.lowered.ops) == _ops(jcp.lowered.ops)
    for attr in ("peak_bytes", "host_pool_bytes", "dma_bytes",
                 "hbm_bytes_saved", "inplace_prefetch_count"):
        assert getattr(tcp, attr) == getattr(jcp, attr), attr
    assert tcp.baseline.arena_bytes == jcp.baseline.arena_bytes
    assert tcp.swapped_names() == jcp.swapped_names()
    assert _untimed(tcp.verify_report.summary()) == \
        _untimed(jcp.verify_report.summary())
    assert _untimed(tcp.deps_report) == _untimed(jcp.deps_report)
    assert _untimed(tcp.report()) == _untimed(jcp.report())


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", GRAPHS)
def test_plan_matches_reference(name, config):
    jcp, tcp = _compiled(name, **CONFIGS[config])
    _assert_same_plan(jcp, tcp)
    assert tcp.verify_report.ok


@pytest.mark.parametrize("planner", sorted(PLANNERS))
@pytest.mark.parametrize("name", GRAPHS)
def test_each_planner_matches_reference(name, planner):
    assert sorted(PLANNERS) == sorted(JPLANNERS)
    jcp, tcp = _compiled(name, min_idle_phases=3, min_bytes=1 << 12,
                         planner=planner, host_planner=planner)
    _assert_same_plan(jcp, tcp)


@pytest.mark.parametrize("name", GRAPHS)
def test_execution_order_and_ideal_memory_match(name):
    for batch in (1, 3):
        jo = j_eo(_graph(jzoo, name), batch)
        to = t_eo(_graph(tzoo, name), batch)
        assert _eo_table(to) == _eo_table(jo)
        assert to.phase_schedule() == jo.phase_schedule()
    assert dataclasses.asdict(t_ideal(_graph(tzoo, name), BATCH)) == \
        dataclasses.asdict(j_ideal(_graph(jzoo, name), BATCH))


def test_full_width_trunk_plans_match():
    """The paper_trunk phase's two plans, at batch 4096, equal the
    reference's: sizes, swap count and the lowered op list."""
    for knobs in ({}, dict(swap=False)):
        jcp = jplan.compile_plan(jzoo.transformer_mlp_stack(),
                                 jplan.MemoryPlanConfig(**knobs), batch=4096)
        tcp = tplan.compile_plan(tzoo.transformer_mlp_stack(),
                                 tplan.MemoryPlanConfig(**knobs), batch=4096)
        assert _ops(tcp.lowered.ops) == _ops(jcp.lowered.ops)
        assert (tcp.peak_bytes, tcp.host_pool_bytes, tcp.dma_bytes,
                tcp.hbm_bytes_saved) == (jcp.peak_bytes, jcp.host_pool_bytes,
                                         jcp.dma_bytes, jcp.hbm_bytes_saved)


MODEL_CASES = [
    ("llama3.2-3b", {}),
    ("llama3.2-3b", dict(remat_budget_bytes=1 << 22)),
    ("llama3.2-3b", dict(remat_budget_bytes=1 << 22, offload=True,
                         dma_gbps=64.0, device_tflops=900.0)),
    ("granite-moe-1b-a400m", dict(remat_budget_bytes=1 << 20,
                                  offload=True)),
    ("zamba2-7b", dict(remat=False)),
]


@pytest.mark.parametrize("arch,knobs", MODEL_CASES)
def test_model_config_remat_plan_matches(arch, knobs):
    jcp = jplan.compile_plan(JARCHS[arch], jplan.MemoryPlanConfig(**knobs),
                             batch_tokens=4096)
    tcp = tplan.compile_plan(ARCHS[arch], tplan.MemoryPlanConfig(**knobs),
                             batch_tokens=4096)
    assert tcp.source == "model"
    if jcp.remat_plan is None:
        assert tcp.remat_plan is None
    else:
        assert dataclasses.asdict(tcp.remat_plan) == \
            dataclasses.asdict(jcp.remat_plan)
        assert tcp.remat_plan.decisions() == jcp.remat_plan.decisions()
    assert (tcp.peak_bytes, tcp.dma_bytes) == (jcp.peak_bytes, jcp.dma_bytes)
    assert _untimed(tcp.report()) == \
        {k: v for k, v in _untimed(jcp.report()).items()
         if k != "offload_lowering"}


def test_unported_policy_and_optimizer_offload_raise():
    cp = tplan.compile_plan(ARCHS["llama3.2-3b"],
                            tplan.MemoryPlanConfig(remat_budget_bytes=1 << 22),
                            batch_tokens=4096)
    # ROADMAP item 8 is done: the plan's policy is the one it decided
    policy = cp.offload_policy
    assert policy.saved == cp.remat_plan.saved
    assert policy.offloaded == cp.remat_plan.offloaded
    assert {n: policy.decision(n) for n in cp.remat_plan.decisions()} \
        == cp.remat_plan.decisions()
    # jit_blocks is ported: the config compiles and names the backend
    cp = tplan.compile_plan(tzoo.ZOO["lenet5"](),
                            tplan.MemoryPlanConfig(executor="jit_blocks"),
                            batch=BATCH)
    assert cp.report()["executor"] == "jit_blocks"
    from repro_torch.core.exec import JitBlocksBackend, get_backend
    assert isinstance(get_backend(cp.config.executor), JitBlocksBackend)
    with pytest.raises(ValueError, match="unknown executor"):
        tplan.compile_plan(tzoo.ZOO["lenet5"](),
                           tplan.MemoryPlanConfig(executor="nope"),
                           batch=BATCH)
