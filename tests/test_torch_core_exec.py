"""Port parity of the replay half of the paper's path: the port's ``sim``
and ``async`` backends replay the compiled op list of every zoo graph (the
swap-forcing config of the reference's backend tests) on the CPU and give
the reference ``sim`` backend's transfer accounting, field by field, and
its grads.  The ``async`` lane runs the CUDA engine's class on the CPU with
an emulated bus.  (The reference's own ``async`` lane cannot run on the CPU:
its donated ``device_put`` raises there, so JAX ``sim`` is the yardstick.)

Also: the engine's host pool and alias groups, the resumable cursor,
verified admission, ``jit_blocks`` resolving to the port's backend, and
the refusal to run without a card."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.core.graph import infer_shapes as j_infer  # noqa: E402
from repro_torch.convert import graph_params_from_numpy  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.exec import (AsyncDeviceBackend,  # noqa: E402
                                   DeviceStreamEngine, SimulatedBackend,
                                   SyncHostEngine, get_backend)
from repro_torch.core.exec.layers import init_params  # noqa: E402
from repro_torch.core.exec.store import (ActivationStore,  # noqa: E402
                                         HbmTracker, HostPool,
                                         SessionScopedEngine, SwapExecStats)
from repro_torch.core.graph import infer_shapes as t_infer  # noqa: E402
from repro_torch.core.verify import ScheduleVerificationError  # noqa: E402

torch.set_num_threads(1)

EXEC = dict(min_idle_phases=3, min_bytes=1 << 12)
STATS_FIELDS = ("swap_outs", "prefetches", "inplace_prefetches", "dma_bytes",
                "hbm_high_water", "host_high_water", "peak_inflight_prefetch")
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


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's compiled plan, params, batch and its sim run."""
    jg = _shrink(jzoo.ZOO[name](), j_infer)
    jcp = jplan.compile_plan(jg, jplan.MemoryPlanConfig(**EXEC), batch=BATCH)
    params = jcp.init_params(jax.random.PRNGKey(0))
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
    loss, grads, stats = jcp.loss_and_grads(params, jnp.asarray(x),
                                            jnp.asarray(y), executor="sim")
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return jcp, to_np(params), x, y, float(loss), to_np(grads), stats


def _port(name):
    tg = _shrink(tzoo.ZOO[name](), t_infer)
    return tplan.compile_plan(tg, tplan.MemoryPlanConfig(**EXEC),
                              batch=BATCH)


def _assert_grads(got, want):
    """rtol 1e-4 with atol 1e-5 per unit of the tensor's largest entry:
    torch's and XLA's CPU convolutions sum in different orders, which moves
    near-zero entries of a large weight gradient (resnet18's reach 8) by up
    to ~3e-6 of that scale."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k])
        for n in want[k]:
            scale = max(1.0, float(np.abs(want[k][n]).max(initial=0.0)))
            np.testing.assert_allclose(got[k][n].numpy(), want[k][n],
                                       rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("executor", ["sim", "async"])
@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_backend_matches_reference_sim(name, executor):
    jcp, params, x, y, jloss, jgrads, jstats = _reference(name)
    cp = _port(name)
    extra = {}
    if executor == "async":
        # the CUDA engine's class on the CPU, with an emulated 8 GB/s bus
        extra["engine"] = DeviceStreamEngine("cpu", bus_gbps=8.0,
                                             bus_latency_s=1e-5)
    loss, grads, stats = cp.loss_and_grads(
        graph_params_from_numpy(params, "cpu"), torch.from_numpy(x),
        torch.from_numpy(y), executor=executor, **extra)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads(grads, jgrads)
    assert stats.backend == executor
    assert stats.replayed_ops == cp.lowered.ops
    assert _ops(stats.replayed_ops) == _ops(jstats.replayed_ops)
    for field in STATS_FIELDS:
        assert getattr(stats, field) == getattr(jstats, field), field
    assert stats.late_swap_ins == jstats.late_swap_ins == 0
    assert (stats.planned_peak, stats.planned_host_pool) == \
        (jstats.planned_peak, jstats.planned_host_pool)
    if executor == "async":
        assert stats.fences == stats.prefetches
        if stats.fences:
            assert 0.0 <= stats.achieved_overlap <= 1.0
            assert stats.hidden_dma_s + stats.exposed_dma_s > 0.0
        report = cp.report()["exec"]
        assert report["fences"] == stats.fences
        assert report["backend"] == "async"


def test_async_backend_keeps_its_host_pool_across_runs():
    jcp, params, x, y, _, jgrads, _ = _reference("lenet5")
    cp = _port("lenet5")
    assert cp.host_pool_bytes > 0
    backend = AsyncDeviceBackend()
    p = graph_params_from_numpy(params, "cpu")
    pools = []
    for _ in range(2):
        _, grads, stats = cp.loss_and_grads(p, torch.from_numpy(x),
                                            torch.from_numpy(y),
                                            executor=backend)
        _assert_grads(grads, jgrads)
        pools.append(backend._pool.buf)
        assert stats.fences == stats.prefetches > 0
        # the stream never held more in flight than the plan budgeted
        assert stats.inflight_high_water <= \
            cp.schedule.peak_inflight_prefetch
    assert pools[0] is pools[1]
    assert pools[0].numel() == cp.host_pool_bytes


def test_hand_wired_schedule_without_a_plan():
    """No plan, no host offsets: each swapped owner gets a host buffer of
    its own, and the replay still matches the reference."""
    from repro_torch.core.exec import swap_planned_loss_and_grads
    jcp, params, x, y, jloss, jgrads, jstats = _reference("lenet5")
    cp = _port("lenet5")
    for executor in ("sim", AsyncDeviceBackend()):
        loss, grads, stats = swap_planned_loss_and_grads(
            cp.graph, graph_params_from_numpy(params, "cpu"),
            torch.from_numpy(x), torch.from_numpy(y), schedule=cp.schedule,
            ordered=cp.ordered, executor=executor)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        _assert_grads(grads, jgrads)
        assert stats.swap_outs == jstats.swap_outs > 0
        assert stats.planned_peak is None


@pytest.mark.parametrize("backend", [SimulatedBackend, AsyncDeviceBackend])
@pytest.mark.parametrize("name", ["lenet5", "resnet18", "tacotron2_decoder"])
def test_sanitizer_cross_checks_every_replayed_op(name, backend):
    """With ``sanitize=True`` the replay steps the verifier's residency
    model beside the store after every op; a clean plan passes all checks
    and gives the reference's grads."""
    jcp, params, x, y, jloss, jgrads, jstats = _reference(name)
    cp = _port(name)
    assert cp.swapped_names()
    loss, grads, stats = cp.loss_and_grads(
        graph_params_from_numpy(params, "cpu"), torch.from_numpy(x),
        torch.from_numpy(y), executor=backend(sanitize=True))
    assert stats.sanitizer_checks == len(cp.lowered.ops) > 0
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads(grads, jgrads)
    _, _, off = cp.loss_and_grads(
        graph_params_from_numpy(params, "cpu"), torch.from_numpy(x),
        torch.from_numpy(y), executor=backend())
    assert off.sanitizer_checks == 0


@pytest.mark.parametrize("backend", [SimulatedBackend, AsyncDeviceBackend])
def test_sanitizer_catches_a_store_that_leaves_the_schedule(backend,
                                                            monkeypatch):
    """A store that ignores the schedule's frees keeps owners resident
    that the static model has retired.  Without the sanitizer the replay
    runs to its end and only the residency peak, checked afterwards, gives
    it away; with it, the replay stops at the first such op and names the
    owner."""
    jcp, params, x, y, _, _, _ = _reference("lenet5")
    cp = _port("lenet5")
    monkeypatch.setattr(ActivationStore, "free_owner",
                        lambda self, owner: None)
    args = (graph_params_from_numpy(params, "cpu"), torch.from_numpy(x),
            torch.from_numpy(y))
    with pytest.raises(AssertionError, match="planned residency peak"):
        cp.loss_and_grads(*args, executor=backend())
    with pytest.raises(AssertionError, match="diverged.*extra=\\['X:"):
        cp.loss_and_grads(*args, executor=backend(sanitize=True))


def test_pool_slots_and_alias_groups():
    """An owner group moves as its storage: an in-place alias and a view
    go to the planned host slot once and come back as views of one new
    buffer; the pool bytes at the slot are the tensor's bytes."""
    pool = HostPool(torch.device("cpu"))
    pool.reserve(256)
    eng = DeviceStreamEngine("cpu", pool=pool)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    members = {"conv": x, "act": x, "flat": x.reshape(12)}
    host = eng.swap_out("X:conv", members, 48, host_offset=32)
    assert len({id(h.buf) for h in host.values()}) == 1
    assert torch.equal(pool.buf[32:80].view(torch.float32), x.reshape(12))
    back = eng.swap_in("X:conv", host, 48)
    assert back["conv"].data_ptr() == back["act"].data_ptr() \
        == back["flat"].data_ptr() != x.data_ptr()
    assert torch.equal(back["act"], x) and back["flat"].shape == (12,)
    stats = SwapExecStats()
    eng.fence("X:conv", stats)
    assert stats.fences == 1 and eng.inflight_bytes == 0
    with pytest.raises(ValueError, match="host slot"):
        eng.swap_out("X:big", {"big": torch.zeros(64)}, 256, host_offset=64)
    with pytest.raises(ValueError, match="more than"):
        eng.swap_out("X:conv", {"conv": torch.zeros(16)}, 16, host_offset=0)


def test_session_scoped_engines_share_a_stream_not_a_pool():
    """Two sessions replaying one plan use the same owner names and host
    offsets: each gets its own pool, and drains only its own copies."""
    inner = DeviceStreamEngine("cpu")
    a, b = (SessionScopedEngine(inner, s) for s in ("a", "b"))
    for eng in (a, b):
        eng.reserve(64)
    xa, xb = torch.full((4,), 1.0), torch.full((4,), 2.0)
    ha = a.swap_out("X:l", {"l": xa}, 16, host_offset=16)
    hb = b.swap_out("X:l", {"l": xb}, 16, host_offset=16)
    ya, yb = a.swap_in("X:l", ha, 16), b.swap_in("X:l", hb, 16)
    assert torch.equal(ya["l"], xa) and torch.equal(yb["l"], xb)
    assert a.inflight_bytes == b.inflight_bytes == 16
    sa = SwapExecStats()
    a.drain(sa)
    assert sa.fences == 1 and a.inflight_bytes == 0
    assert b.inflight_bytes == 16 and inner.inflight_bytes == 16


def test_schedule_cursor_phase_by_phase_then_abort():
    jcp, params, x, y, jloss, jgrads, jstats = _reference("model_c_linear")
    cp = _port("model_c_linear")
    p = graph_params_from_numpy(params, "cpu")
    backend = SimulatedBackend()
    args = (cp.graph, p, torch.from_numpy(x), torch.from_numpy(y))
    kw = dict(schedule=cp.schedule, ordered=cp.ordered, plan=cp.plan,
              lowered=cp.lowered)
    cursor = backend.start(*args, **kw)
    steps = 0
    while cursor.advance():
        steps += 1
        assert cursor.phases_done == steps
    assert cursor.phases_done == cursor.phases_total
    loss, grads, stats = cursor.result()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads(grads, jgrads)
    assert stats.replayed_ops == cp.lowered.ops

    half = backend.start(*args, **kw)
    for _ in range(half.phases_total // 2):
        half.advance()
    assert half.store.device
    half.abort()
    assert half.aborted and not half.store.device and not half.store.alive
    assert not half.advance()
    with pytest.raises(RuntimeError, match="aborted"):
        half.result()


def test_admission_refuses_an_unverified_schedule():
    from repro_torch.core.plan import ExecutionSchedule, Prefetch
    jcp, params, x, y, *_ = _reference("lenet5")
    cp = _port("lenet5")
    ops = cp.lowered.ops
    drop = next(i for i, op in enumerate(ops) if isinstance(op, Prefetch))
    broken = ExecutionSchedule(ops=ops[:drop] + ops[drop + 1:])
    for executor in ("sim", "async"):
        with pytest.raises(ScheduleVerificationError):
            get_backend(executor).run(
                cp.graph, graph_params_from_numpy(params, "cpu"),
                torch.from_numpy(x), torch.from_numpy(y),
                schedule=cp.schedule, ordered=cp.ordered, plan=cp.plan,
                lowered=broken)


def test_unported_paths_raise():
    # jit_blocks is ported: the name resolves to the port's backend, and a
    # plan replays on it (its parity: tests/test_torch_jit_blocks.py)
    from repro_torch.core.exec import JitBlocksBackend
    assert isinstance(get_backend("jit_blocks"), JitBlocksBackend)
    jcp, params, x, y, jloss, jgrads, _ = _reference("lenet5")
    cp = _port("lenet5")
    loss, grads, stats = cp.loss_and_grads(
        graph_params_from_numpy(params, "cpu"), torch.from_numpy(x),
        torch.from_numpy(y), executor="jit_blocks")
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_grads(grads, jgrads)
    assert stats.backend == "jit_blocks"
    # ROADMAP item 8 is done: the policy and the tag no longer raise
    from repro_torch.core.remat_policy import RematPlan, tag
    policy = RematPlan(("qkv",), (), 0, 0.0, offloaded=("mlp_hidden",)
                       ).policy()
    assert [policy.decision(n) for n in ("qkv", "mlp_hidden", "attn_out")] \
        == ["keep", "offload", "recompute"]
    x = torch.zeros(1)
    assert tag("qkv", x) is x


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")


def test_entry_points_refuse_to_run_without_a_card(no_card):
    cp = _port("model_a_linear")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cp.init_params(gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cp.graph, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStreamEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        SyncHostEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncDeviceBackend(device="cuda").make_engine(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        graph_params_from_numpy({"l": {"w": np.zeros(2)}})
    with pytest.raises(RuntimeError, match="CUDA"):
        ActivationStore(cp.ordered, HbmTracker())
    # asked for the CPU, the same entry points run there
    p = cp.init_params(gen, device="cpu")
    x = torch.randn((BATCH,) + tuple(cp.graph.input_shape))
    y = torch.randn((BATCH,) + tuple(cp.graph.label_shape))
    loss, grads, _ = cp.loss_and_grads(p, x, y, executor="async")
    assert loss.device.type == "cpu"
    assert all(g.device.type == "cpu" for v in grads.values()
               for g in v.values())
