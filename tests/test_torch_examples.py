"""The paper's examples on the port (``examples/torch_*.py``): each
``main(device="cpu")`` runs at reduced iteration counts with its own
assertions and its loss falls, and the quickstart's plan reports equal the
reference's ``compile_plan(...).report()`` for the same graphs and
configs."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import plan as jplan  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.core.plan import ExecutionSchedule, Prefetch  # noqa: E402
from repro.core.verify import verify_schedule  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _untimed(obj):
    """``obj`` without its wall-clock entries (they differ run to run)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if "wall_time" not in k}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_untimed(v) for v in obj)
    return obj


@pytest.fixture(scope="module")
def quickstart():
    return _example("torch_quickstart")


def test_quickstart_runs_every_demo_on_the_cpu(quickstart, capsys):
    out = quickstart.main(device="cpu", train_steps=10, resume_steps=14)
    assert out["train"]["final"] < out["train"]["first"]
    assert out["async"]["backend"] == "async"
    assert out["async"]["swap_outs"] > 0
    assert out["serve"]["serve"]["completed"] == 4
    assert out["concurrent_serve"]["scheduler"]["verify_errors"] == 0
    text = capsys.readouterr().out
    assert "[error:use_before_resident]" in text
    assert "resumed loss" in text


def _reference(graph, batch, **knobs):
    return jplan.compile_plan(graph, jplan.MemoryPlanConfig(**knobs),
                              batch=batch)


def test_quickstart_graph_plan_report_equals_the_reference(quickstart):
    want = _reference(jzoo.ZOO["lenet5"](), 16, planner="bestfit",
                      host_planner="segregated", **quickstart.SWAPPING)
    assert _untimed(quickstart.graph_plan_demo()) == _untimed(want.report())


def test_quickstart_optim_offload_report_equals_the_reference(quickstart):
    want = _reference(jzoo.ZOO["vgg16"](), 4, optim_offload=True,
                      **quickstart.SWAPPING)
    assert _untimed(quickstart.optim_offload_demo()) == \
        _untimed(want.report())


def test_quickstart_verify_demo_equals_the_reference(quickstart):
    cp = _reference(jzoo.ZOO["lenet5"](), 16, planner="bestfit",
                    host_planner="segregated", **quickstart.SWAPPING)
    dropped = next(op for op in cp.lowered.ops if isinstance(op, Prefetch))
    forged = ExecutionSchedule(
        ops=tuple(op for op in cp.lowered.ops if op is not dropped))
    want = verify_schedule(cp.ordered, cp.schedule, cp.plan, forged)
    assert _untimed(quickstart.verify_demo()) == _untimed(want.summary())


def test_personalize_transfer_loss_falls_on_the_cpu():
    out = _example("torch_personalize_transfer").main(device="cpu",
                                                      epochs=15)
    assert len(out["losses"]) == 15
    assert out["losses"][-1] < out["losses"][0]
    # Fig. 12: the frozen backbone's plan is smaller than full training's
    assert out["transfer_peak_bytes"] < out["full_peak_bytes"]


def test_tts_unroll_loss_falls_below_nine_tenths_on_the_cpu():
    out = _example("torch_tts_unroll").main(device="cpu", iterations=80)
    assert out["losses"][-1] < 0.9 * out["losses"][0]
    assert out["shared"] > 0 and out["owned"] > 0
