"""Port parity of the optimizer-state offload: the ``O:`` slot plan, its
lowering to ``OptPrefetch``/``OptSwapOut``, the int8 block quantizer, the
resident optimizers, ``OptimRuntime``/``offloaded_update`` and the
replay's optimizer counters, each against the JAX package on the same
numpy inputs (mirrors ``tests/test_optim_offload.py``).

The reference's ``async`` lane cannot run on the CPU (its donated
``device_put`` raises there), so its ``sim`` backend is the yardstick for
the port's ``sim`` and ``async`` lanes."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import optim_offload as joo  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.convert import (graph_params_from_numpy,  # noqa: E402
                                 optim_state_from_numpy)
from repro_torch.core import optim_offload as too  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.exec import DeviceStreamEngine  # noqa: E402
from repro_torch.core.exec.store import SwapExecStats  # noqa: E402
from repro_torch.core.plan import (Compute, ExecutionSchedule,  # noqa: E402
                                   OptPrefetch, OptSwapOut)
from repro_torch.core.verify import CHECKS, verify_schedule  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

torch.set_num_threads(1)

CFG = dict(min_idle_phases=3, min_bytes=1 << 12)
PLAN_CASES = [("lenet5", 8, True), ("lenet5", 8, False), ("vgg16", 4, True),
              ("resnet18_transfer", 8, True), ("product_rating", 8, True)]


def _cfg(mod, compress=True, **kw):
    return mod.MemoryPlanConfig(optim_offload=True, optim_compress=compress,
                                **CFG, **kw)


@functools.lru_cache(maxsize=None)
def _plans(name, batch, compress):
    jcp = jplan.compile_plan(jzoo.ZOO[name](), _cfg(jplan, compress),
                             batch=batch)
    tcp = tplan.compile_plan(tzoo.ZOO[name](), _cfg(tplan, compress),
                             batch=batch)
    return jcp, tcp


def _ops(ops):
    return [(type(op).__name__, dataclasses.astuple(op)) for op in ops]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _untimed(obj):
    """``obj`` without its wall-clock entries (they differ run to run)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if "wall_time" not in k}
    return obj


@functools.lru_cache(maxsize=None)
def _lenet(compress=True, steps=3):
    """The reference's lenet5 plan, its params, and a stream of numpy
    grads shaped like them (AdamW-scale, a decade apart across layers)."""
    jcp, tcp = _plans("lenet5", 8, compress)
    params = _np(jcp.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    grads = [{k: {n: (rng.standard_normal(w.shape) * 10.0 ** -(i % 3))
                  .astype(np.float32) for n, w in entry.items()}
              for i, (k, entry) in enumerate(params.items())}
             for _ in range(steps)]
    return jcp, tcp, params, grads


def _max_err(a, b):
    return max(float(np.abs(np.asarray(a[k][n]) - b[k][n].numpy()).max())
               for k in a for n in a[k])


def _t(tree):
    return graph_params_from_numpy(tree, "cpu")


# ---------------------------------------------------------------------------
# the plan: slots, arenas, pricing, lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,batch,compress", PLAN_CASES)
def test_plan_slots_and_summary_equal_the_reference(name, batch, compress):
    jcp, tcp = _plans(name, batch, compress)
    jo, to = jcp.optim_plan, tcp.optim_plan
    assert [dataclasses.astuple(s) for s in to.slots] == \
        [dataclasses.astuple(s) for s in jo.slots]
    assert to.summary() == jo.summary()
    for kind in ("device", "host"):
        jp, tp = getattr(jo, kind), getattr(to, kind)
        assert {k: (p.offset, p.nbytes) for k, p in tp.placements.items()} \
            == {k: (p.offset, p.nbytes) for k, p in jp.placements.items()}
    to.validate()
    assert tcp.optim_device_bytes == jcp.optim_device_bytes
    assert tcp.report()["optim"] == jcp.report()["optim"]


@pytest.mark.parametrize("name,batch,compress", PLAN_CASES)
def test_lowered_opt_ops_equal_the_reference(name, batch, compress):
    jcp, tcp = _plans(name, batch, compress)
    assert _ops(tcp.lowered.ops) == _ops(jcp.lowered.ops)
    pre = [op for op in tcp.lowered.ops if isinstance(op, OptPrefetch)]
    out = [op for op in tcp.lowered.ops if isinstance(op, OptSwapOut)]
    assert len(pre) == len(out) == len(tcp.optim_plan.slots)
    assert _untimed(tcp.verify_report.summary()) == \
        _untimed(jcp.verify_report.summary())


def test_default_config_carries_no_optimizer_plan():
    cp = tplan.compile_plan(tzoo.ZOO["lenet5"](), tplan.MemoryPlanConfig(
        **CFG), batch=8)
    assert cp.optim_plan is None and cp.optim_device_bytes == 0
    assert not any(isinstance(op, (OptPrefetch, OptSwapOut))
                   for op in cp.lowered.ops)
    assert "optim" not in cp.report()


def test_frozen_layers_get_no_slot_and_vgg16_reduction():
    _, tcp = _plans("resnet18_transfer", 8, True)
    frozen = {l.name for l in tcp.graph.layers if not l.trainable}
    assert frozen and not frozen & {s.layer for s in tcp.optim_plan.slots}
    _, vgg = _plans("vgg16", 4, True)
    assert vgg.optim_plan.reduction_x >= 3.0
    assert vgg.optim_plan.host_pool_bytes < vgg.optim_plan.host_fp32_bytes


def test_corrupt_opt_offset_caught_only_by_optim_region():
    from repro_torch.core.planner import ALIGN
    _, cp = _plans("lenet5", 8, True)
    assert "optim_region" in CHECKS
    rep = verify_schedule(cp.ordered, cp.schedule, cp.plan, cp.lowered)
    assert rep.ok and "optim_region" in rep.checks_run
    p = next(op for op in cp.lowered.ops if isinstance(op, OptPrefetch))
    forged = ExecutionSchedule(ops=tuple(
        dataclasses.replace(op, device_offset=op.device_offset + 2 * ALIGN)
        if op is p else op for op in cp.lowered.ops))
    rep = verify_schedule(cp.ordered, cp.schedule, cp.plan, forged)
    assert not rep.ok and set(rep.check_ids()) == {"optim_region"}


# ---------------------------------------------------------------------------
# the int8 block quantizer
# ---------------------------------------------------------------------------

def _quant_input(n, kind, rng):
    if kind == "normal":
        return (rng.standard_normal(n) * 3).astype(np.float32)
    if kind == "zero_blocks":         # all-zero blocks take scale 1.0
        x = np.zeros(n, np.float32)
        x[300:] = rng.standard_normal(x[300:].shape)
        return x
    if kind == "ties":                # halves on the int8 grid: x.5 ties
        x = (rng.integers(-254, 255, n) / 2.0).astype(np.float32)
        x[0] = 127.0
        return x
    # the encoded v half: 0.5 * log(v + 1e-16) over many decades
    v = (rng.standard_normal(n) ** 2 * 1e-6).astype(np.float32)
    return (0.5 * np.log(v + np.float32(1e-16))).astype(np.float32)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 12305])
@pytest.mark.parametrize("kind", ["normal", "zero_blocks", "ties", "log"])
def test_quantizer_bit_for_bit(n, kind):
    x = _quant_input(n, kind, np.random.default_rng(n))
    jq, js = jcomp._q(jnp.asarray(x))
    tq, ts = tcomp._q(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp._deq(tq, ts, (n,)).numpy(), np.asarray(jcomp._deq(jq, js,
                                                                (n,))))
    # the runtime's in-place re-quantizer is the same function
    q, scale = torch.empty_like(tq), torch.empty_like(ts)
    res = torch.empty(n)
    too._requantize_(torch.from_numpy(x), q, scale, res)
    assert torch.equal(q, tq) and torch.equal(scale, ts)
    assert torch.equal(res, torch.from_numpy(x) - tcomp._deq(tq, ts, (n,)))


def test_error_feedback_helpers_match_the_reference():
    rng = np.random.default_rng(0)
    g = {"a": {"w": rng.standard_normal((7, 41)).astype(np.float32)},
         "b": [rng.standard_normal(300).astype(np.float32)]}
    e = jax.tree_util.tree_map(lambda a: (a * 1e-3).astype(np.float32), g)
    jc, jr = jcomp.error_feedback_update(g, e)
    tg = tcomp.tree_map(torch.from_numpy, g)
    tc, tr = tcomp.error_feedback_update(tg, tcomp.tree_map(
        torch.from_numpy, e))
    for path in (("a", "w"), ("b", 0)):
        jleaf, tleaf = jc, tc
        jres, tres = jr, tr
        for k in path:
            jleaf, tleaf, jres, tres = jleaf[k], tleaf[k], jres[k], tres[k]
        np.testing.assert_array_equal(tleaf["q"].numpy(),
                                      np.asarray(jleaf["q"]))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    back = tcomp.decompress_gradients(tcomp.compress_gradients(tg), tg)
    ref = jcomp.decompress_gradients(jcomp.compress_gradients(g), g)
    np.testing.assert_array_equal(back["a"]["w"].numpy(),
                                  np.asarray(ref["a"]["w"]))


# ---------------------------------------------------------------------------
# the resident optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.adamw(), lambda m: m.adamw(state_dtype="bfloat16"),
    lambda m: m.adamw(state_dtype="int8"), lambda m: m.sgd_momentum(),
    lambda m: m.make_optimizer("adamw", lr=1e-3, weight_decay=0.0)],
    ids=["adamw_f32", "adamw_bf16", "adamw_int8", "sgd", "make_adamw"])
def test_resident_optimizers_match_the_reference(make):
    _, _, params, grads = _lenet()
    jo, to = make(jopt), make(topt)
    assert to.name == jo.name
    jp, tp = params, _t(params)
    js, ts = jo.init(jp), to.init(tp)
    # one compile, not one per eager op; the int8 state runs op by op,
    # because XLA's fused quantizer rounds a tie differently from its own
    # op-by-op run (and from torch's), which a step later is O(1e-6)
    update = jo.update if jo.name == "adamw_int8" else jax.jit(jo.update)
    for g in grads:
        jp, js = update(g, js, jp)
        tp, ts = to.update(_t(g), ts, tp)
    assert _max_err(jp, tp) <= 1e-6
    if "count" in ts:
        assert int(ts["count"]) == int(js["count"]) == len(grads)
        assert ts["count"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the runtime: host tier + offloaded update
# ---------------------------------------------------------------------------

def _runtime_pair(compress):
    jcp, tcp, _, _ = _lenet(compress)
    return (joo.OptimRuntime(jcp.optim_plan, jcp.graph),
            too.OptimRuntime(tcp.optim_plan, tcp.graph, device="cpu"))


def _int8_diffs(jrt, trt):
    """(entries whose int8 value differs, of which by more than one)."""
    n = big = 0
    for layer, hs in jrt.host_state.items():
        d = np.abs(np.asarray(hs["q"], np.int32)
                   - trt.host_state[layer]["q"].numpy().astype(np.int32))
        n += int((d > 0).sum())
        big += int((d > 1).sum())
    return n, big


def test_runtime_initial_state_equals_the_reference():
    jrt, trt = _runtime_pair(True)
    for layer, hs in jrt.host_state.items():
        for part in ("q", "scale"):
            np.testing.assert_array_equal(
                trt.host_state[layer][part].numpy(), np.asarray(hs[part]))
        np.testing.assert_array_equal(trt.residual[layer].numpy(),
                                      np.asarray(jrt.residual[layer]))
    assert trt.host_bytes > 0


@pytest.mark.parametrize("compress", [False, True])
def test_offloaded_update_matches_the_reference_runtime(compress):
    """Both runtimes take the same numpy grads from the same params.
    Uncompressed: within 1e-6.  Compressed: the host copies are int8, so
    a one-ulp difference between XLA's and torch's exp/log may move an
    entry one step across a rounding tie; the params stay within 1e-6 and
    no int8 entry moves by more than one step."""
    _, _, params, grads = _lenet(compress)
    jrt, trt = _runtime_pair(compress)
    jp, tp = params, _t(params)
    for g in grads:
        jp = joo.offloaded_update(jrt, jp, g)
        tp = too.offloaded_update(trt, tp, _t(g))
        err = _max_err(jp, tp)
        if compress:
            n, big = _int8_diffs(jrt, trt)
            assert err <= 1e-6 and big == 0, \
                f"params err {err}; {n} int8 entries differ, {big} by >1"
        else:
            assert err <= 1e-6, err
    assert trt.count == jrt.count == len(grads)
    assert all(v >= 0.0 for v in trt.timings.values())


def test_port_runtime_continues_a_reference_runtime():
    """``optim_state_from_numpy`` carries q, scale, residual and count."""
    _, _, params, grads = _lenet()
    jrt, trt = _runtime_pair(True)
    jp = params
    for g in grads[:2]:
        jp = joo.offloaded_update(jrt, jp, g)
    optim_state_from_numpy(trt, _np(jrt.host_state), _np(jrt.residual),
                           jrt.count)
    tp = too.offloaded_update(trt, _t(jp), _t(grads[2]))
    jp = joo.offloaded_update(jrt, jp, grads[2])
    assert trt.count == 3
    assert _max_err(jp, tp) <= 1e-6


def _resident_and_offloaded(compress, steps, first_grads_only=False):
    """The reference test's loop on the port: the port's resident AdamW
    and offloaded update fed the same grad stream (grads at the resident
    params, the port's own sim replay)."""
    _, tcp, params, _ = _lenet(compress)
    rt = too.OptimRuntime(tcp.optim_plan, tcp.graph, device="cpu")
    opt = topt.adamw()
    ref_p = off_p = _t(params)
    state = opt.init(ref_p)
    gen = torch.Generator().manual_seed(3)
    for _ in range(steps):
        x = torch.randn((8, 3, 32, 32), generator=gen)
        y = torch.nn.functional.one_hot(
            torch.randint(0, 10, (8,), generator=gen), 10).float()
        _, grads, _ = tcp.loss_and_grads(ref_p, x, y, executor="sim")
        ref_p, state = opt.update(grads, state, ref_p)
        off_p = too.offloaded_update(rt, off_p, grads)
    return max(float((ref_p[k][n] - off_p[k][n]).abs().max())
               for k in ref_p for n in ref_p[k])


@pytest.mark.parametrize("compress,steps,tol", [
    (True, 1, 1e-6),       # step 1 decodes the exact zero state
    (False, 3, 1e-5),      # uncompressed: float noise
    (True, 8, 2e-2),       # compressed with EF: the reference's bound
], ids=["first_step_exact", "uncompressed", "compressed"])
def test_offloaded_update_tracks_the_port_resident_adamw(compress, steps,
                                                         tol):
    err = _resident_and_offloaded(compress, steps)
    assert err <= tol, err


def test_offloaded_update_counts_stats():
    _, tcp, params, grads = _lenet()
    rt = too.OptimRuntime(tcp.optim_plan, tcp.graph, device="cpu")
    stats = SwapExecStats()
    too.offloaded_update(rt, _t(params), _t(grads[0]), stats)
    n = len(tcp.optim_plan.slots)
    assert stats.opt_prefetches == n and stats.opt_swap_outs == n
    assert stats.opt_dma_bytes == tcp.optim_plan.dma_bytes_per_step
    assert stats.opt_compressed_bytes == sum(
        s.host_nbytes for s in tcp.optim_plan.slots)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("executor", ["sim", "async"])
def test_replay_updates_the_state_like_offloaded_update(executor, compress):
    """A replay given an ``OffloadedStep`` moves the runtime's own host
    copies at its ``OptPrefetch`` ops and updates each slot at its
    ``OptSwapOut``: bit for bit the params and host state that
    ``offloaded_update`` makes from the replay's grads, with the counters
    of the plain replay."""
    _, tcp, params, _ = _lenet(compress)
    a = too.OptimRuntime(tcp.optim_plan, tcp.graph, device="cpu")
    b = too.OptimRuntime(tcp.optim_plan, tcp.graph, device="cpu")
    pa = pb = _t(params)
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):
        x = torch.randn((8, 3, 32, 32), generator=gen)
        y = torch.nn.functional.one_hot(
            torch.randint(0, 10, (8,), generator=gen), 10).float()
        extra = {"engine": DeviceStreamEngine("cpu")} \
            if executor == "async" else {}
        step = too.OffloadedStep(a, pa)
        _, grads, stats = tcp.loss_and_grads(pa, x, y, executor=executor,
                                             optim=step, **extra)
        pa = step.new_params
        pb = too.offloaded_update(b, pb, grads)
        assert stats.replayed_ops == tcp.lowered.ops
        assert stats.opt_prefetches == stats.opt_swap_outs \
            == len(tcp.optim_plan.slots)
        assert stats.opt_dma_bytes == tcp.optim_plan.dma_bytes_per_step
        for k in pb:
            for n in pb[k]:
                assert torch.equal(pa[k][n], pb[k][n]), (k, n)
    assert a.count == b.count == 3
    for layer, hs in b.host_state.items():
        for part, want in (hs.items() if compress else [("state", hs)]):
            got = a.host_state[layer] if not compress \
                else a.host_state[layer][part]
            assert torch.equal(got, want), (layer, part)
    assert a.timings["h2d_s"] > 0.0 and a.timings["d2h_s"] > 0.0


def test_replay_refuses_an_optimizer_step_of_another_plan():
    """The step's slots must be the ones the schedule moves: an fp32
    runtime cannot ride a compressed plan's optimizer ops."""
    _, tcp, params, _ = _lenet(True)
    _, flat, _, _ = _lenet(False)
    rt = too.OptimRuntime(flat.optim_plan, flat.graph, device="cpu")
    x = torch.zeros((8, 3, 32, 32))
    y = torch.nn.functional.one_hot(torch.arange(8) % 10, 10).float()
    with pytest.raises(ValueError, match="slots"):
        tcp.loss_and_grads(_t(params), x, y, executor="sim",
                           optim=too.OffloadedStep(rt, _t(params)))


# ---------------------------------------------------------------------------
# the replay's optimizer lane
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_replay():
    jcp, tcp, params, _ = _lenet()
    x = np.random.default_rng(1).standard_normal((8, 3, 32, 32)) \
        .astype(np.float32)
    y = np.eye(10, dtype=np.float32)[np.arange(8) % 10]
    loss, grads, stats = jcp.loss_and_grads(params, jnp.asarray(x),
                                            jnp.asarray(y), executor="sim")
    return tcp, params, x, y, float(loss), _np(grads), stats


@pytest.mark.parametrize("executor", ["sim", "async"])
def test_backends_replay_opt_ops_like_the_reference_sim(executor):
    cp, params, x, y, jloss, jgrads, js = _reference_replay()
    extra = {}
    if executor == "async":
        extra["engine"] = DeviceStreamEngine("cpu", bus_gbps=8.0,
                                             bus_latency_s=1e-5)
    loss, grads, stats = cp.loss_and_grads(
        _t(params), torch.from_numpy(x), torch.from_numpy(y),
        executor=executor, **extra)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    for k in jgrads:
        for n in jgrads[k]:
            np.testing.assert_allclose(grads[k][n].numpy(), jgrads[k][n],
                                       rtol=1e-4, atol=1e-5)
    assert stats.replayed_ops == cp.lowered.ops
    for field in ("opt_prefetches", "opt_swap_outs", "opt_dma_bytes",
                  "opt_compressed_bytes", "opt_device_high_water"):
        assert getattr(stats, field) == getattr(js, field), field
    assert stats.opt_device_high_water <= cp.optim_plan.device_peak_bytes
    if executor == "async":
        # every optimizer prefetch was fenced at its read phase's compute
        assert stats.opt_fences == stats.opt_prefetches
        assert stats.opt_hidden_dma_s + stats.opt_exposed_dma_s > 0.0
        rep = cp.report()["exec"]
        assert rep["opt_fences"] == stats.opt_fences
        assert 0 < rep["opt_inflight_high_water"] \
            <= cp.optim_plan.host_pool_bytes


def test_opt_fence_waits_at_the_first_compute_of_the_read_phase():
    """The replay fences an optimizer slot exactly when its read phase's
    first Compute runs: no slot is still in flight then."""
    cp, params, x, y, *_ = _reference_replay()
    from repro_torch.core.exec import AsyncDeviceBackend
    eng = DeviceStreamEngine("cpu")
    cursor = AsyncDeviceBackend().start(
        cp.graph, _t(params), torch.from_numpy(x), torch.from_numpy(y),
        schedule=cp.schedule, ordered=cp.ordered, plan=cp.plan,
        lowered=cp.lowered, engine=eng)
    reads = {op.tensor: op.read_eo for op in cp.lowered.ops
             if isinstance(op, OptPrefetch)}
    while True:
        phase = cursor._phases[cursor.phases_done]
        more = cursor.advance()
        eo = phase[0][1].eo
        if any(isinstance(op, Compute) for _, op in phase):
            assert not {t for t, r in reads.items() if r <= eo} \
                & set(eng._opt_inflight)
        if not more:
            break
    assert not eng._opt_inflight and eng.opt_inflight_bytes == 0
    assert eng.opt_inflight_high_water > 0
