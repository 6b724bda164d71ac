"""The comparison fails what it must: a run whose train step is broken
underneath (the state left unchanged; half the batch left out, the mean
taken over the rest) comes out not correct, at a tiny width on the CPU;
and on the card, at the cell's own size and under its own limits, so
does the control, the reference with its weight products in float8, put
in the program's place."""

import json
import sys

import pytest

from tiny import CELLS, ROOT, make_root, run_cpu

sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FAULTS = {
    "state_unchanged": """
import repro_torch.train.step as _s
_make = _s.make_train_step
def _broken(model, optimizer, shape, **kw):
    bundle = _make(model, optimizer, shape, **kw)
    def fn(params, opt_state, batch):
        loss = model.loss_fn(params, batch)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": loss}
    bundle.fn = fn
    return bundle
_s.make_train_step = _broken
""",
    "half_batch": """
import repro_torch.train.step as _s
_make = _s.make_train_step
def _broken(model, optimizer, shape, microbatches=1, **kw):
    bundle = _make(model, optimizer, shape,
                   microbatches=max(microbatches // 2, 1), **kw)
    whole = bundle.fn
    def fn(params, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return whole(params, opt_state, half)
    bundle.fn = fn
    return bundle
_s.make_train_step = _broken
""",
}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(CELLS))
def test_broken_step_is_not_correct(tiny_root, cell, fault):
    res = run_cpu(tiny_root, cell, patch=FAULTS[fault])
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_float8_control_is_not_correct(cell):
    """On the card at the cell's own size (where the limits were read):
    the program passes the cell's limits and the control fails them, on
    each of 3 seeds.  At the tiny width the control's gaps and the
    program's overlap, so this runs only where the cell runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    from chipbench import correct, harness
    c = harness.load_cell(cell)
    limits = c.workload["limits"]
    for seed in (3100000021, 3100000022, 3100000023):
        prog = harness.Program(c, seed, "cuda")
        readings = prog.first_steps(c.workload["followed_steps"])
        prog = None
        harness.free()
        ref = harness.reference_readings(c, seed, "cuda")
        control = harness.reference_readings(c, seed, "cuda",
                                             precision="float8")
        assert correct.judge(readings, ref, limits)[0], seed
        assert not correct.judge(control, ref, limits)[0], seed
        harness.free()
