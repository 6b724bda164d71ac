"""Port parity of the phase-interleaved multi-session scheduler (mirrors
the scheduler half of ``tests/test_serve.py``): sessions round-robin at
phase boundaries over one shared copy-stream engine (its CPU emulation
here), each session's grads equal the reference's ``sim`` replay on the
same numpy params and batch, overlapping shares and duplicate users are
refused, a kill at a phase boundary drains only the killed session, and
QoS weights buy phase advances.  Also the session-scoped engine's
optimizer lane and stall-risk signal, and the card-clock overlap
arithmetic behind ``cross_hidden_dma_s``."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro_torch.convert import graph_params_from_numpy  # noqa: E402
from repro_torch.core import MemoryPlanConfig, compile_plan  # noqa: E402
from repro_torch.core.exec import DeviceStreamEngine  # noqa: E402
from repro_torch.core.exec.store import (SessionScopedEngine,  # noqa: E402
                                         SwapExecStats, _overlap)
from repro_torch.core.verify import (ScheduleVerificationError,  # noqa: E402
                                     SessionArenaSlice, verify_interleaving)
from repro_torch.core.zoo import ZOO  # noqa: E402
from repro_torch.runtime.fault import FaultInjector  # noqa: E402
from repro_torch.serve import (PersonalizationService,  # noqa: E402
                               ServeStats, SessionWork, StepScheduler,
                               dummy_batch)

torch.set_num_threads(1)

CFG_KW = dict(min_idle_phases=3, min_bytes=1 << 12)
CFG = MemoryPlanConfig(**CFG_KW)


@functools.lru_cache(maxsize=None)
def _reference(seeds):
    """Per seed: the reference's lenet5 params, a numpy batch and its sim
    replay's loss and grads."""
    jg = jzoo.ZOO["lenet5"]()
    jcp = jplan.compile_plan(jg, jplan.MemoryPlanConfig(**CFG_KW), batch=8)
    out = []
    for seed in seeds:
        params = jcp.init_params(jax.random.PRNGKey(seed))
        r = np.random.default_rng(seed)
        x = r.standard_normal((8, 3, 32, 32)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.integers(0, 10, 8)]
        loss, grads, _ = jcp.loss_and_grads(params, jnp.asarray(x),
                                            jnp.asarray(y), executor="sim")
        to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
        out.append((to_np(params), x, y, float(loss), to_np(grads)))
    return out


def _engine():
    return DeviceStreamEngine("cpu", bus_gbps=8.0, bus_latency_s=1e-5)


def _works(cp, users, *, qos="standard", weight=1.0):
    """SessionWork items over disjoint fixed shares, with the reference's
    params and batches (seeds 0, 1, ...)."""
    share = cp.peak_bytes + cp.optim_device_bytes
    out = []
    for i, u in enumerate(users):
        params, x, y, _, _ = _reference(tuple(range(len(users))))[i]
        p = graph_params_from_numpy(params, "cpu")
        out.append(SessionWork(
            user=u, arrival=i + 1, qos=qos, weight=weight,
            base_offset=i * share, share_bytes=share, cp=cp,
            x=torch.from_numpy(x), y=torch.from_numpy(y), mask=None,
            params_fn=lambda p=p: p))
    return out


def _assert_grads(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        for n, b in want[k].items():
            scale = max(1.0, float(np.abs(b).max(initial=0.0)))
            np.testing.assert_allclose(got[k][n].numpy(), b, rtol=1e-4,
                                       atol=1e-5 * scale)


def test_scheduler_interleaves_sessions_with_correct_grads():
    """N sessions round-robin at phase boundaries over one shared engine;
    every session's loss and grads equal the reference's sim replay, its
    replayed stream equals the compiled op list, and cross-session DMA
    overlap is measured on the host clock of the emulated bus."""
    cp = compile_plan(ZOO["lenet5"](), CFG, batch=8)
    works = _works(cp, ["a", "b", "c"])
    sched = StepScheduler(engine=_engine())
    outs = sched.run(works)
    assert [o.user for o in outs] == ["a", "b", "c"]
    for i, (w, o) in enumerate(zip(works, outs)):
        _, _, _, jloss, jgrads = _reference((0, 1, 2))[i]
        assert o.ok
        np.testing.assert_allclose(o.loss, jloss, rtol=1e-5)
        _assert_grads(o.grads, jgrads)
        assert o.stats.replayed_ops == cp.lowered.ops
        assert o.stats.hbm_high_water <= w.share_bytes
        assert o.stats.cross_hidden_dma_s >= 0.0
    rep = sched.report()
    assert rep["sessions"] == 3 and rep["completed"] == 3
    assert rep["verify_errors"] == 0 and rep["rounds"] > 1
    assert rep["hidden_dma_s"] + rep["exposed_dma_s"] > 0.0
    assert rep["cross_hidden_clock"] == "host"
    assert rep["cross_hidden_dma_s"] > 0.0
    assert not sched.engine._inflight and not sched.engine._opt_inflight


def test_a_wave_waits_for_the_card_once():
    """A session's end makes the host wait for nothing: its losses stay
    tensors while the wave runs (what ``follow_up`` sees), and the shared
    engine settles once, after the wave, when the losses become floats."""
    cp = compile_plan(ZOO["lenet5"](), CFG, batch=8)

    class Counting(DeviceStreamEngine):
        settles = 0

        def settle(self):
            Counting.settles += 1
            super().settle()

    seen = []
    sched = StepScheduler(engine=Counting("cpu", bus_gbps=8.0,
                                          bus_latency_s=1e-5))
    outs = sched.run(_works(cp, ["a", "b", "c"]),
                     follow_up=lambda o: seen.append(
                         (type(o.loss), Counting.settles)))
    assert Counting.settles == 1
    assert seen == [(torch.Tensor, 0)] * 3
    assert all(type(o.loss) is float for o in outs)


def test_scheduler_rejects_overlapping_shares_and_duplicate_users():
    cp = compile_plan(ZOO["lenet5"](), CFG, batch=8)
    works = _works(cp, ["a", "b"])
    bad = dataclasses.replace(works[1], base_offset=works[0].base_offset)
    with pytest.raises(ScheduleVerificationError) as ei:
        StepScheduler(engine=_engine()).run([works[0], bad])
    assert any(d.check == "cross_session_arena"
               for d in ei.value.diagnostics)
    dup = [works[0], dataclasses.replace(works[1], user="a")]
    with pytest.raises(ValueError):
        StepScheduler(engine=_engine()).run(dup)


def test_verify_interleaving_unit():
    sl = [SessionArenaSlice("a", "standard", 0, 1000, 900),
          SessionArenaSlice("b", "standard", 1000, 1000, 1000)]
    assert verify_interleaving(sl).ok
    bad = [sl[0], SessionArenaSlice("b", "standard", 500, 1000, 900)]
    rep = verify_interleaving(bad)
    assert not rep.ok and "cross_session_arena" in rep.check_ids()
    assert not verify_interleaving(
        [SessionArenaSlice("a", "standard", 0, 1000, 1001)]).ok


def test_scheduler_kill_mid_step_releases_survivors_unharmed():
    cp = compile_plan(ZOO["lenet5"](), CFG, batch=8)
    works = _works(cp, ["a", "b", "c"])
    inj = FaultInjector()
    inj.arm_kill("session:b", after=1)        # fires at the 2nd boundary
    sched = StepScheduler(engine=_engine(), injector=inj)
    by_user = {o.user: o for o in sched.run(works)}
    assert by_user["b"].status == "killed"
    assert "phase boundary" in by_user["b"].reason
    assert inj.fired == ["session:b"]
    # the aborted cursor drained its in-flight DMA: nothing leaks into the
    # shared engine the survivors keep using
    assert not sched.engine._inflight and not sched.engine._opt_inflight
    for i, u in ((0, "a"), (2, "c")):
        assert by_user[u].ok
        _assert_grads(by_user[u].grads, _reference((0, 1, 2))[i][4])
    assert sched.report()["killed"] == 1


def test_service_kill_at_phase_boundary_releases_reservation():
    g = ZOO["lenet5"]()
    inj = FaultInjector()
    svc = PersonalizationService(g, buckets=(8,), max_live_sessions=2,
                                 config=CFG, injector=inj, device="cpu")
    svc.warmup()
    inj.arm_kill("session:bob", after=1)
    svc.enqueue("alice", *dummy_batch(g, 8, seed=0, device="cpu"))
    svc.enqueue("bob", *dummy_batch(g, 8, seed=1, device="cpu"))
    r_alice, r_bob = svc.drain()
    assert r_alice.ok
    assert r_bob.status == "killed"
    assert "phase boundary" in r_bob.reason and "released" in r_bob.reason
    assert "bob" not in svc.admission.live
    assert "bob" not in svc.servable.sessions
    assert svc.stats.killed == 1
    assert svc.submit("bob", *dummy_batch(g, 8, seed=2, device="cpu")).ok


def test_qos_weighted_rounds_and_starvation_accounting():
    cp = compile_plan(ZOO["lenet5"](), CFG, batch=8)
    prem, std = _works(cp, ["prem", "std"])
    works = [dataclasses.replace(prem, qos="premium", weight=2.0),
             dataclasses.replace(std, qos="standard", weight=1.0)]
    stats = ServeStats()
    outs = StepScheduler(engine=_engine()).run(works, stats)
    assert all(o.ok for o in outs)
    assert stats.qos_stats("standard").bypassed_phases > 0
    assert stats.qos_stats("premium").bypassed_phases == 0


def test_interleaved_sessions_replay_the_optimizer_lane():
    """Sessions whose plans offload optimizer state stream each slot's
    compressed bytes on the shared engine, fenced per session."""
    cp = compile_plan(ZOO["lenet5"](),
                      MemoryPlanConfig(optim_offload=True, **CFG_KW),
                      batch=8)
    works = _works(cp, ["a", "b"])
    sched = StepScheduler(engine=_engine())
    outs = sched.run(works)
    n = len(cp.optim_plan.slots)
    for i, o in enumerate(outs):
        assert o.ok and o.stats.replayed_ops == cp.lowered.ops
        assert o.stats.opt_prefetches == o.stats.opt_fences == n
        assert o.stats.opt_device_high_water \
            <= cp.optim_plan.device_peak_bytes
        _assert_grads(o.grads, _reference((0, 1))[i][4])
    assert sched.report()["opt_hidden_dma_s"] > 0.0


# ---------------------------------------------------------------------------
# the session-scoped engine and the card-clock overlap arithmetic
# ---------------------------------------------------------------------------

def test_session_scoped_optimizer_lane_and_stall_signal():
    """Each session streams optimizer bytes from its own pool at the
    planned offset; ``has_inflight``/``next_ready_at`` describe only its
    own copies, and ``drain`` fences only them."""
    inner = _engine()
    a, b = (SessionScopedEngine(inner, s) for s in ("a", "b"))
    for eng in (a, b):
        eng.reserve(0, 256)
    assert not a.has_inflight and a.next_ready_at == 0.0
    sa, sb = SwapExecStats(), SwapExecStats()
    a.opt_swap_in("O:l", 512, 128, sa, host_offset=64)
    a.opt_swap_in("O:l", 512, 128, sa, host_offset=64)   # already in flight
    b.opt_swap_in("O:l", 512, 128, sb, host_offset=64)
    assert a.has_inflight and a.opt_inflight_bytes == 128
    assert inner.opt_inflight_bytes == 256
    assert a.next_ready_at > 0.0
    with pytest.raises(ValueError, match="host slot"):
        a.opt_swap_in("O:big", 512, 256, sa, host_offset=128)
    a.drain(sa)
    assert sa.opt_fences == 1 and not a.has_inflight
    assert b.has_inflight and inner.opt_inflight_bytes == 128
    b.opt_fence("O:l", sb)
    assert sb.opt_fences == 1 and inner.opt_inflight_bytes == 0
    assert a.opt_inflight_high_water == b.opt_inflight_high_water == 128


def test_cross_session_overlap_counts_only_other_sessions_phases():
    """The card-clock credit: a session's hidden copy window intersected
    with the phases that other sessions ran (None marks idle time)."""
    starts = [0.0, 1.0, 2.0, 3.0, 5.0]
    ends = [1.0, 2.0, 3.0, 5.0, 6.0]
    scopes = ["a", "b", "a", None, "b"]
    phases = (starts, ends, scopes)
    assert _overlap(phases, "a", 0.5, 2.5) == pytest.approx(1.0)
    assert _overlap(phases, "b", 0.5, 2.5) == pytest.approx(1.0)
    assert _overlap(phases, "a", 2.5, 5.5) == pytest.approx(0.5)
    assert _overlap(phases, "a", 3.0, 5.0) == 0.0
    assert _overlap(phases, "c", 0.0, 6.0) == pytest.approx(4.0)


@pytest.mark.parametrize("executor", ["sim", "async"])
def test_a_finished_replay_frees_its_buffers_without_the_cycle_collector(
        executor):
    """A session's grads and activations die with the caller's last
    reference: the cursor drops its compute env (whose accessors close
    over the cursor) when the step ends, so a long serving loop never
    waits for the cyclic collector to return device memory."""
    import gc
    import weakref
    cp = compile_plan(ZOO["lenet5"](), CFG, batch=8)
    params = graph_params_from_numpy(_reference((0,))[0][0], "cpu")
    x, y = (torch.from_numpy(a) for a in _reference((0,))[0][1:3])
    gc.disable()
    try:
        loss, grads, stats = cp.loss_and_grads(params, x, y,
                                               executor=executor)
        alive = weakref.ref(grads["c1"]["w"])
        del loss, grads, stats
        assert alive() is None
    finally:
        gc.enable()
