"""The port's ``jit_blocks`` executor on the CPU: each block the dependence
prover fuses runs as one call of the interpreter (on the card, one
CUDA-graph replay: ``tests/test_torch_cuda_core.py``), every activation
held in the plan's packed device arena at its planned offset.

Held to the reference: loss and grads of all 16 zoo graphs against JAX's
``reference_loss_and_grads`` and the port's ``sim``, and the replayed
stream op for op against the JAX package's ``replay_stream(plan_fusion)``
on the reference's own compile (pure Python: the reference's jit_blocks
lane itself does not run on this JAX).  Also: the arena's views, the
sanitizer, two runs, admission of a forged fusion, the optimizer lane."""

import dataclasses
import functools
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core import verify as jverify  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.core.exec import layers as jl  # noqa: E402
from repro.core.graph import infer_shapes as j_infer  # noqa: E402
from repro_torch.convert import graph_params_from_numpy  # noqa: E402
from repro_torch.core import optim_offload as too  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.exec import (ArenaActivationStore,  # noqa: E402
                                   AsyncDeviceBackend, DeviceStreamEngine,
                                   JitBlocksBackend, get_backend)
from repro_torch.core.exec import backends as tbackends  # noqa: E402
from repro_torch.core.graph import infer_shapes as t_infer  # noqa: E402
from repro_torch.core.verify import (ScheduleVerificationError,  # noqa
                                     plan_fusion, replay_stream,
                                     schedules_equivalent)
from repro_torch.core.verify import deps as tdeps  # noqa: E402

torch.set_num_threads(1)

EXEC = dict(min_idle_phases=3, min_bytes=1 << 12)
BATCH = 2


def _shrink(graph, infer):
    for l in graph.layers:
        if l.attrs.get("in_features") == 150528:
            l.attrs["in_features"] = 96
    if graph.input_shape == (150528,):
        object.__setattr__(graph, "input_shape", (96,))
    infer(graph)
    return graph


def _ops(ops):
    return [(type(op).__name__, dataclasses.astuple(op)) for op in ops]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's compile, params, a batch, autograd's loss and grads
    and its fused replay stream."""
    jg = _shrink(jzoo.ZOO[name](), j_infer)
    jcp = jplan.compile_plan(jg, jplan.MemoryPlanConfig(**EXEC), batch=BATCH)
    params = _np(jcp.init_params(jax.random.PRNGKey(0)))
    r = np.random.default_rng(1)
    if any(l.kind == "embedding" for l in jg.layers):
        x = r.integers(0, 50, (BATCH,) + tuple(jg.input_shape)) \
            .astype(np.int32)
    else:
        x = r.standard_normal((BATCH,) + tuple(jg.input_shape)) \
            .astype(np.float32)
    y = r.standard_normal((BATCH,) + tuple(jg.label_shape)).astype(np.float32)
    if jg.layers[-1].kind == "loss_ce":
        y = np.eye(y.shape[-1], dtype=np.float32)[np.argmax(y, -1)]
    loss, grads = jax.jit(
        lambda p, a, b: jl.reference_loss_and_grads(jg, p, a, b))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(y))
    stream = jverify.replay_stream(
        jcp.lowered, jverify.plan_fusion(jcp.lowered, jcp.ordered, jcp.plan))
    return params, x, y, float(loss), _np(grads), stream


def _port(name, **knobs):
    tg = _shrink(tzoo.ZOO[name](), t_infer)
    return tplan.compile_plan(
        tg, tplan.MemoryPlanConfig(**{**EXEC, **knobs}), batch=BATCH)


def _args(name):
    params, x, y, *_ = _reference(name)
    return (graph_params_from_numpy(params, "cpu"), torch.from_numpy(x),
            torch.from_numpy(y))


def _assert_grads(got, want, rtol=1e-4, atol=1e-5):
    """rtol with atol per unit of the tensor's largest entry: torch's and
    XLA's CPU convolutions sum in different orders (resnet18's weight
    grads reach 8)."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k])
        for n in want[k]:
            w = np.asarray(want[k][n])
            scale = max(1.0, float(np.abs(w).max(initial=0.0)))
            np.testing.assert_allclose(np.asarray(got[k][n]), w, rtol=rtol,
                                       atol=atol * scale)


def _clone(grads):
    return {k: {n: t.clone() for n, t in e.items()} for k, e in grads.items()}


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_zoo_graph_matches_the_reference(name):
    params, x, y, jloss, jgrads, jstream = _reference(name)
    cp = _port(name)
    args = _args(name)
    loss, grads, stats = cp.loss_and_grads(*args, executor="jit_blocks")
    report = cp.report()["exec"]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
    _assert_grads(grads, jgrads)
    sloss, sgrads, sstats = cp.loss_and_grads(*args, executor="sim")
    np.testing.assert_allclose(float(loss), float(sloss), rtol=1e-5)
    _assert_grads(grads, sgrads, rtol=1e-5, atol=0.0)

    ops = cp.lowered.ops
    assert Counter(stats.replayed_ops) == Counter(ops)
    schedules_equivalent(cp.lowered, stats.replayed_ops, ordered=cp.ordered,
                         plan=cp.plan).raise_if_errors()
    fusion = plan_fusion(cp.lowered, cp.ordered, cp.plan)
    assert stats.replayed_ops == replay_stream(cp.lowered, fusion)
    # transfers never fuse; a block takes its deferred frees with it
    n_eager = sum(not isinstance(op, (tplan.Compute, tplan.Free))
                  for op in ops)
    assert n_eager + len(fusion.blocks) <= stats.dispatch_calls < len(ops)
    assert stats.dispatch_calls == fusion.dispatch_calls()
    # the JAX package's fused stream on its own compile, op for op
    assert _ops(stats.replayed_ops) == _ops(jstream)
    for field in ("swap_outs", "prefetches", "dma_bytes", "hbm_high_water",
                  "host_high_water", "peak_inflight_prefetch"):
        assert getattr(stats, field) == getattr(sstats, field), field
    assert stats.late_swap_ins == 0 and stats.graph_captures == 0
    assert report["backend"] == "jit_blocks"
    assert report["fusion"] == fusion.summary()
    assert report["arena_bytes"] == cp.peak_bytes


def _watch_arena(monkeypatch, seen):
    """Check the store after every put and transfer: each held tracked
    member a view of the arena at its owner's offset (pre before a swap,
    post after), members of one owner inside its region."""
    def check(store):
        base, arena = store.arena.base, store.arena
        for m, t in store.device.items():
            owner = store.owner_of(m)
            if owner is None:
                continue
            lo = store.at[owner]
            pre, post = store.offsets[owner]
            assert lo == (post if owner in seen["swapped_in"] else pre)
            lay = store.layout[m]
            assert t.untyped_storage().data_ptr() == base
            assert t.data_ptr() == base + lo + lay.offset * t.element_size()
            assert lo % t.element_size() == 0
            assert lo + store.ordered.tensors[owner].nbytes <= arena.nbytes
            if t.data_ptr() == base + lo and m != owner[2:]:
                seen["aliases"] += 1

    def wrap(method, after=None):
        orig = getattr(ArenaActivationStore, method)

        def run(self, *a, **kw):
            out = orig(self, *a, **kw)
            if after is not None:
                after(a[0])
            check(self)
            return out
        monkeypatch.setattr(ArenaActivationStore, method, run)

    wrap("put")
    wrap("swap_out", lambda owner: seen["swapped_out"].add(owner))
    wrap("swap_in", lambda owner: seen["swapped_in"].add(owner))


@pytest.mark.parametrize("name", ["lenet5", "resnet18", "vgg16"])
def test_held_activations_are_views_of_the_arena(name, monkeypatch):
    seen = {"swapped_out": set(), "swapped_in": set(), "aliases": 0}
    _watch_arena(monkeypatch, seen)
    cp = _port(name)
    backend = JitBlocksBackend()
    _, grads, stats = cp.loss_and_grads(*_args(name), executor=backend)
    assert backend.arena.nbytes == cp.peak_bytes
    assert seen["swapped_in"] and seen["swapped_in"] <= seen["swapped_out"]
    assert seen["aliases"] > 0                  # in-place activations
    assert stats.arena_copy_bytes > 0
    _assert_grads(grads, _reference(name)[4])


def test_swap_free_plan_is_one_block_in_its_arena():
    """A plan without swaps reaches the backend as its arena plan only:
    no fence splits its computes, so the step is one dispatch."""
    cp = _port("resnet18", swap=False)
    backend = JitBlocksBackend()
    loss, grads, stats = cp.loss_and_grads(*_args("resnet18"),
                                           executor=backend)
    n_compute = sum(isinstance(op, tplan.Compute) for op in cp.lowered.ops)
    fusion = plan_fusion(cp.lowered, cp.ordered)
    assert len(fusion.blocks) == 1 and fusion.fused_computes() == n_compute
    assert stats.dispatch_calls == fusion.dispatch_calls()
    assert backend.arena.nbytes == cp.peak_bytes
    _assert_grads(grads, _reference("resnet18")[4])


@pytest.mark.parametrize("name", ["lenet5", "resnet18",
                                  "tacotron2_decoder"])
def test_sanitizer_cross_checks_every_replayed_op(name):
    cp = _port(name)
    backend = JitBlocksBackend(sanitize=True)
    _, grads, stats = cp.loss_and_grads(*_args(name), executor=backend)
    assert stats.sanitizer_checks == len(cp.lowered.ops)
    assert backend.report()["fusion"]["dispatch_calls"] \
        == stats.dispatch_calls
    _assert_grads(grads, _reference(name)[4])


def test_two_runs_agree_and_the_second_builds_nothing():
    """The arena and the gradient buffers are kept; two runs give the same
    bits.  New parameter tensors give their own grads (on the card their
    new addresses capture the blocks again)."""
    cp = _port("resnet18")
    params, x, y = _args("resnet18")
    backend = JitBlocksBackend()
    loss1, grads1, _ = cp.loss_and_grads(params, x, y, executor=backend)
    arena, bufs = backend.arena, backend._grad_bufs[1]
    kept = _clone(grads1)
    loss2, grads2, stats = cp.loss_and_grads(params, x, y, executor=backend)
    assert backend.arena is arena and backend._grad_bufs[1] is bufs
    assert stats.graph_captures == 0
    assert torch.equal(loss1, loss2)
    for k in kept:
        for n in kept[k]:
            assert torch.equal(grads2[k][n], kept[k][n])
            assert grads2[k][n] is bufs[k][n]
    moved = {k: {n: w * 1.5 for n, w in e.items()}
             for k, e in params.items()}
    _, grads3, _ = cp.loss_and_grads(moved, x, y, executor=backend)
    _, want, _ = cp.loss_and_grads(moved, x, y, executor="sim")
    _assert_grads(grads3, want, rtol=1e-6, atol=0.0)
    assert any(not torch.equal(grads3[k][n], kept[k][n])
               for k in kept for n in kept[k])


def test_a_forged_fusion_is_refused_before_any_op_runs(monkeypatch):
    """A fusion plan whose block spans a Prefetch fails verify_fusion: the
    backend raises before it allocates its arena or runs a compute."""
    cp = _port("lenet5")
    real = plan_fusion(cp.lowered, cp.ordered, cp.plan)
    ops = cp.lowered.ops
    pf = next(i for i, op in enumerate(ops) if isinstance(op, tplan.Prefetch)
              and any(isinstance(o, tplan.Compute) for o in ops[:i])
              and any(isinstance(o, tplan.Compute) for o in ops[i + 1:]))
    before = max(i for i in range(pf) if isinstance(ops[i], tplan.Compute))
    after = min(i for i in range(pf + 1, len(ops))
                if isinstance(ops[i], tplan.Compute))
    forged = dataclasses.replace(real, blocks=(tdeps.FusedBlock(
        index=0, op_indices=(before, after), compute_indices=(before, after),
        free_indices=()),))
    monkeypatch.setattr("repro_torch.core.verify.plan_fusion",
                        lambda *a, **k: forged)
    steps = []
    monkeypatch.setattr(tbackends._ComputeEnv, "step",
                        lambda self, op: steps.append(op))
    backend = JitBlocksBackend()
    with pytest.raises(ScheduleVerificationError, match="fusion_fence"):
        cp.loss_and_grads(*_args("lenet5"), executor=backend)
    assert steps == [] and backend.arena is None


def test_refusals():
    cp = _port("lenet5")
    args = _args("lenet5")
    backend = get_backend("jit_blocks")
    assert isinstance(backend, JitBlocksBackend)
    with pytest.raises(ValueError, match="engine"):
        cp.loss_and_grads(*args, executor=backend,
                          engine=DeviceStreamEngine("cpu"))
    with pytest.raises(ValueError, match="needs the plan"):
        tbackends.swap_planned_loss_and_grads(
            cp.graph, *args, schedule=cp.schedule, ordered=cp.ordered,
            executor=backend)


def test_scheduler_serves_on_jit_blocks():
    """``StepScheduler(backend=JitBlocksBackend())`` serves a lenet5 wave,
    as the reference's does (its jit_blocks inherits the async cursor):
    each session's loss and grads equal the JAX ``sim`` replay's on the
    same params and batch, its replayed stream is the compiled op list,
    and the cursor touches none of the backend's arena or fusion state."""
    from repro_torch.serve import SessionWork, StepScheduler
    cfg = dict(min_idle_phases=3, min_bytes=1 << 12)
    jg = jzoo.ZOO["lenet5"]()
    jcp = jplan.compile_plan(jg, jplan.MemoryPlanConfig(**cfg), batch=8)
    cp = tplan.compile_plan(tzoo.ZOO["lenet5"](),
                            tplan.MemoryPlanConfig(**cfg), batch=8)
    share = cp.peak_bytes + cp.optim_device_bytes
    backend = JitBlocksBackend()
    works, wants = [], []
    for i, user in enumerate(["a", "b"]):
        params = _np(jcp.init_params(jax.random.PRNGKey(i)))
        r = np.random.default_rng(i)
        x = r.standard_normal((8, 3, 32, 32)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.integers(0, 10, 8)]
        loss, grads, _ = jcp.loss_and_grads(params, jnp.asarray(x),
                                            jnp.asarray(y), executor="sim")
        wants.append((float(loss), _np(grads)))
        p = graph_params_from_numpy(params, "cpu")
        works.append(SessionWork(
            user=user, arrival=i + 1, qos="standard", weight=1.0,
            base_offset=i * share, share_bytes=share, cp=cp,
            x=torch.from_numpy(x), y=torch.from_numpy(y), mask=None,
            params_fn=lambda p=p: p))
    sched = StepScheduler(backend=backend,
                          engine=DeviceStreamEngine("cpu", bus_gbps=8.0,
                                                    bus_latency_s=1e-5))
    outs = sched.run(works)
    assert [o.user for o in outs] == ["a", "b"]
    for o, (jloss, jgrads) in zip(outs, wants):
        assert o.ok
        np.testing.assert_allclose(o.loss, jloss, rtol=1e-5)
        assert sorted(o.grads) == sorted(jgrads)
        for k in jgrads:
            for n, b in jgrads[k].items():
                scale = max(1.0, float(np.abs(b).max(initial=0.0)))
                np.testing.assert_allclose(o.grads[k][n].numpy(), b,
                                           rtol=1e-4, atol=1e-5 * scale)
        assert o.stats.replayed_ops == cp.lowered.ops
    assert backend.arena is None and backend._admitted == {}
    assert sched.report()["completed"] == 2


def test_optimizer_lane_matches_async():
    """lenet5 with its optimizer state offloaded: the opt counters and the
    OffloadedStep's state and params equal the port's async replay's."""
    cp = _port("lenet5", optim_offload=True, min_bytes=1 << 20)
    assert cp.optim_plan is not None
    params, x, y = _args("lenet5")
    got = {}
    for name, backend in (("async", AsyncDeviceBackend()),
                          ("jit_blocks", JitBlocksBackend())):
        rt = too.OptimRuntime(cp.optim_plan, cp.graph, device="cpu")
        p = params
        for _ in range(2):
            step = too.OffloadedStep(rt, p)
            extra = {"engine": DeviceStreamEngine("cpu")} \
                if name == "async" else {}
            _, _, stats = cp.loss_and_grads(p, x, y, executor=backend,
                                            optim=step, **extra)
            p = step.new_params
        got[name] = (stats, rt, p)
    (sa, ra, pa), (sj, rj, pj) = got["async"], got["jit_blocks"]
    for field in ("opt_prefetches", "opt_swap_outs", "opt_dma_bytes",
                  "opt_compressed_bytes", "opt_device_high_water",
                  "opt_fences"):
        assert getattr(sj, field) == getattr(sa, field), field
    assert sj.opt_prefetches == len(cp.optim_plan.slots)
    for k in pa:
        for n in pa[k]:
            assert torch.equal(pj[k][n], pa[k][n]), (k, n)
    for layer, hs in ra.host_state.items():
        for part, want in hs.items():
            assert torch.equal(rj.host_state[layer][part], want), layer
