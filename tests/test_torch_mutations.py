"""The port's mutation harness (``tools/torch_mutate_schedule.py``): every
corruption class forged on the port's reference plan is flagged with the
check ids the reference's ``tools/mutate_schedule.py`` reports for the
same forgery on its own plan, and the clean plan is clean."""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def results():
    """(the port's verdicts, the reference's) per class."""
    port, ref = _load("torch_mutate_schedule"), _load("mutate_schedule")
    return port, port.run_all(port.reference_plan()), \
        _reference_verdicts(ref)


def _reference_verdicts(ref):
    cp = ref.reference_plan()
    out = {}
    for name, (expected, _) in ref.mutations(cp).items():
        report = ref.verify_schedule(cp.ordered, cp.schedule, cp.plan,
                                     ref.forge(cp, name))
        out[name] = (expected, sorted(report.check_ids()))
    for name, (expected, forge) in ref.FUSION_MUTATIONS.items():
        diags = ref.verify_fusion(forge(cp), cp.lowered, cp.ordered, cp.plan)
        out[name] = (expected, sorted({d.check for d in diags}))
    for name, (expected, forge) in ref.INTERLEAVE_MUTATIONS.items():
        out[name] = (expected,
                     sorted(ref.verify_interleaving(forge(cp)).check_ids()))
    return out


CLASSES = ["shift_offset", "drop_prefetch", "reorder_swap_out",
           "double_free", "truncate_free", "budget_overflow", "misalign",
           "corrupt_opt_offset", "hoist_compute", "drop_dep_edge",
           "fuse_across_swap", "overlap_arena_shares"]


@pytest.mark.parametrize("name", CLASSES)
def test_class_flagged_with_the_reference_check_ids(results, name):
    _, port, ref = results
    expected, got, caught = port[name]
    assert caught, (name, got)
    assert (expected, got) == ref[name]


def test_every_class_covered_and_clean_plan_clean(results):
    harness, port, ref = results
    assert sorted(port) == sorted(ref) == sorted(CLASSES)
    cp = harness.reference_plan()
    clean = harness.verify_schedule(cp.ordered, cp.schedule, cp.plan,
                                    cp.lowered)
    assert clean.ok and not clean.errors()
    assert harness.main() == 0
