"""Port parity of multi-tenant personalization serving (mirrors
``tests/test_serve.py``): buckets and pad-to-bucket numerics, the
budget-keyed compile cache, admission control, fault-injection kills
releasing arena reservations, shared-plan QoS acceptance, the optimizer
offload accounting and the ``personalize`` CLI, on the CPU.

Grads are held to the reference's: its FIFO service (or ``sim`` replay)
on the same numpy traffic, with the port's base parameters converted from
the reference's.  The reference's ``async`` lane cannot run on the CPU
(its donated ``device_put`` raises there), so its FIFO service is the
yardstick for the port's interleaved one too.  The LM prefill tests of
``tests/test_serve.py`` belong to ``generate``, not here."""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.serve import PersonalizationService as JService  # noqa: E402
from repro_torch.convert import graph_params_from_numpy  # noqa: E402
from repro_torch.core import (ArenaBudgetError, MemoryPlanConfig,  # noqa: E402
                              compile_plan, compile_plan_under_budget)
from repro_torch.core.exec.layers import (init_params,  # noqa: E402
                                          reference_loss_and_grads)
from repro_torch.core.zoo import ZOO  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.runtime.fault import FaultInjector  # noqa: E402
from repro_torch.serve import (AdmissionController,  # noqa: E402
                               PersonalizationService, PlanCache, QosClass,
                               ServablePersonalizer, choose_bucket,
                               dummy_batch, pad_to_bucket)
from repro_torch.core.verify import verify_interleaving  # noqa: E402

torch.set_num_threads(1)

CFG_KW = dict(min_idle_phases=3, min_bytes=1 << 12)
CFG = MemoryPlanConfig(**CFG_KW)


def _batch(g, n, seed):
    """A numpy batch both packages take: normal x; one-hot y under a
    cross-entropy loss, normal y otherwise."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n,) + tuple(g.input_shape)).astype(np.float32)
    if g.layers[-1].kind == "loss_ce":
        y = np.eye(g.label_shape[-1], dtype=np.float32)[
            r.integers(0, g.label_shape[-1], n)]
    else:
        y = r.standard_normal((n,) + tuple(g.label_shape)).astype(np.float32)
    return x, y


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _dummy(g, n, seed):
    return dummy_batch(g, n, seed=seed, device="cpu")


def _service(g, **kw):
    return PersonalizationService(g, device="cpu", **kw)


def _assert_grads(got, want):
    """rtol 1e-4 with atol 1e-5 per unit of the tensor's largest entry
    (torch's and XLA's CPU convolutions sum in different orders)."""
    assert sorted(got) == sorted(want)
    for k in want:
        for n, b in want[k].items():
            b = np.asarray(b)
            scale = max(1.0, float(np.abs(b).max(initial=0.0)))
            np.testing.assert_allclose(got[k][n].numpy(), b, rtol=1e-4,
                                       atol=1e-5 * scale)


def _record_grads(svc, into):
    """Record every (user, grads as numpy) the service applies."""
    apply = svc.servable.apply_update

    def recording(sess, grads):
        into.append((sess.user, {k: {n: np.array(v) for n, v in e.items()}
                                 for k, e in grads.items()}))
        apply(sess, grads)
    svc.servable.apply_update = recording


def _share_base(port_svc, ref_svc):
    port_svc.servable.base_params = graph_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_svc.servable.base_params),
        "cpu")


# ---------------------------------------------------------------------------
# Buckets and padding
# ---------------------------------------------------------------------------

def test_choose_bucket_smallest_fit():
    assert choose_bucket(1, (8, 16)) == 8
    assert choose_bucket(8, (16, 8)) == 8      # order-insensitive
    assert choose_bucket(9, (8, 16)) == 16
    assert choose_bucket(17, (8, 16)) is None
    assert choose_bucket(0, (8, 16)) is None


def test_pad_to_bucket_shapes_and_mask():
    g = ZOO["lenet5"]()
    x, y = _dummy(g, 5, 0)
    xp, yp, mask = pad_to_bucket(x, y, 8)
    assert xp.shape == (8,) + tuple(g.input_shape)
    assert yp.shape == (8,) + tuple(g.label_shape)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), [1, 1, 1, 1, 1, 0, 0, 0])
    assert torch.equal(xp[:5], x) and not xp[5:].any()
    x8, y8 = _dummy(g, 8, 0)
    xf, yf, mf = pad_to_bucket(x8, y8, 8)
    assert xf is x8 and yf is y8 and mf is None
    with pytest.raises(ValueError):
        pad_to_bucket(x8, y8, 4)


def test_dummy_batch_is_seeded_and_one_hot():
    g = ZOO["lenet5"]()
    x, y = _dummy(g, 6, 3)
    x2, y2 = _dummy(g, 6, 3)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert y.shape == (6, 10) and torch.equal(y.sum(-1), torch.ones(6))
    assert not torch.equal(x, _dummy(g, 6, 4)[0])


@pytest.mark.parametrize("name,n,bucket", [
    ("lenet5", 5, 8),
    ("model_b_conv2d", 3, 8),
])
def test_padded_bucket_grads_match_unpadded(name, n, bucket):
    """Masked padded-bucket grads == unpadded grads, == the masked
    autograd reference, == the reference package's padded replay."""
    jg = jzoo.ZOO[name]()
    jparams = jax.tree_util.tree_map(
        np.asarray, jplan.compile_plan(jg, jplan.MemoryPlanConfig(**CFG_KW),
                                       batch=bucket).init_params(
            jax.random.PRNGKey(0)))
    g = ZOO[name]()
    params = graph_params_from_numpy(jparams, "cpu")
    x, y = _batch(g, n, 3)
    cp_n = compile_plan(g, CFG, batch=n)
    loss_ref, grads_ref = cp_n.loss_and_grads(params, *_t(x, y))[:2]
    cp_b = compile_plan(g, CFG, batch=bucket)
    xp, yp, mask = pad_to_bucket(*_t(x, y), bucket)
    loss_pad, grads_pad, _ = cp_b.loss_and_grads(params, xp, yp, mask=mask)
    np.testing.assert_allclose(float(loss_pad), float(loss_ref),
                               rtol=1e-4, atol=1e-6)
    _assert_grads(grads_pad, {k: {m: v.numpy() for m, v in e.items()}
                              for k, e in grads_ref.items()})
    ref_loss, ref_grads = reference_loss_and_grads(g, params, xp, yp,
                                                   mask=mask)
    np.testing.assert_allclose(float(loss_pad), float(ref_loss),
                               rtol=1e-4, atol=1e-6)
    _assert_grads(grads_pad, {k: {m: v.detach().numpy() for m, v in e.items()}
                              for k, e in ref_grads.items()})
    # the reference package's padded bucket, same numpy inputs
    jcp = jplan.compile_plan(jg, jplan.MemoryPlanConfig(**CFG_KW),
                             batch=bucket)
    jl, jgrads, _ = jcp.loss_and_grads(jparams, jnp.asarray(xp.numpy()),
                                       jnp.asarray(yp.numpy()),
                                       mask=jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(float(loss_pad), float(jl), rtol=1e-5)
    _assert_grads(grads_pad, jgrads)


# ---------------------------------------------------------------------------
# The compile cache: full-config keying
# ---------------------------------------------------------------------------

def test_plan_cache_hit_and_miss_counters():
    g = ZOO["lenet5"]()
    cache = PlanCache()
    cp1 = cache.get_or_compile(g, CFG, bucket=8)
    cp2 = cache.get_or_compile(g, CFG, bucket=8)
    assert cp1 is cp2
    assert (cache.hits, cache.misses) == (1, 1)
    cache.get_or_compile(g, CFG, bucket=16)
    assert (cache.hits, cache.misses) == (1, 2)
    assert len(cache) == 2
    assert cache.report() == {"entries": 2, "hits": 1, "misses": 2,
                              "hit_rate": 0.3333}


def test_plan_cache_no_collision_across_configs_or_budgets():
    g = ZOO["lenet5"]()
    cache = PlanCache()
    base = cache.get_or_compile(g, CFG, bucket=8)
    other_cfg = cache.get_or_compile(
        g, MemoryPlanConfig(min_idle_phases=2, min_bytes=1 << 12), bucket=8)
    assert other_cfg is not base
    budget = base.peak_bytes + (1 << 20)
    other_budget = cache.get_or_compile(g, CFG, bucket=8,
                                        arena_budget_bytes=budget)
    assert other_budget is not base
    assert cache.hits == 0 and cache.misses == 3
    k1 = CFG.cache_key()
    k2 = MemoryPlanConfig(min_idle_phases=2, min_bytes=1 << 12).cache_key()
    assert k1 != k2 and len(k1) == len(k2)


def test_compile_plan_under_budget_escalates_and_rejects():
    g = ZOO["lenet5"]()
    base = compile_plan(g, MemoryPlanConfig(swap=False), batch=8)
    budget = int(base.peak_bytes * 0.9)
    cp = compile_plan_under_budget(g, MemoryPlanConfig(), batch=8,
                                   arena_budget_bytes=budget)
    assert cp.peak_bytes <= budget and cp.verify_report.ok
    jcp = jplan.compile_plan_under_budget(
        jzoo.ZOO["lenet5"](), jplan.MemoryPlanConfig(), batch=8,
        arena_budget_bytes=budget)
    assert (cp.peak_bytes, cp.dma_bytes) == (jcp.peak_bytes, jcp.dma_bytes)
    with pytest.raises(ArenaBudgetError) as ei:
        compile_plan_under_budget(g, MemoryPlanConfig(), batch=8,
                                  arena_budget_bytes=1 << 10)
    assert ei.value.best_peak_bytes > ei.value.arena_budget_bytes == 1 << 10


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_admission_slots_shares_release():
    ac = AdmissionController(max_live_sessions=2, device_budget_bytes=1000)
    assert ac.arena_share_bytes == 500
    assert ac.try_admit("a") == 500
    assert ac.try_admit("a") == 500          # idempotent, no double booking
    assert ac.reserved_bytes == 500
    assert ac.try_admit("b") == 500
    assert ac.try_admit("c") is None         # full
    assert ac.rejections == 1
    assert ac.release("b") and not ac.release("b")
    assert ac.try_admit("c") == 500          # freed slot reusable
    assert ac.live == ("a", "c")


def test_qos_classes_price_shares_and_gate_admission():
    ac = AdmissionController(
        max_live_sessions=3, device_budget_bytes=4000,
        qos=(QosClass("premium", weight=2.0, slots=1),
             QosClass("standard", weight=1.0, slots=2)))
    assert ac.share_for("premium") == 2000
    assert ac.share_for("standard") == 1000
    assert ac.try_admit("p", qos="premium") == 2000
    assert ac.base_offset("p") == 0
    assert ac.try_admit("s1", qos="standard") == 1000
    assert ac.try_admit("s2", qos="standard") == 1000
    assert sorted(ac.base_offset(u) for u in ("s1", "s2")) == [2000, 3000]
    assert ac.try_admit("p2", qos="premium") is None
    with pytest.raises(ValueError):
        ac.try_admit("p", qos="standard")
    assert verify_interleaving(ac.arena_slices()).ok
    assert ac.release("p")
    assert ac.try_admit("p2", qos="premium") == 2000


def test_service_rejects_gracefully_and_recovers():
    g = ZOO["lenet5"]()
    svc = _service(g, buckets=(8,), max_live_sessions=1, config=CFG)
    assert svc.submit("alice", *_dummy(g, 8, 0)).ok
    r2 = svc.submit("bob", *_dummy(g, 8, 1))
    assert r2.status == "rejected" and "slot" in r2.reason
    assert svc.stats.rejected_admission == 1 and svc.stats.deadlocks == 0
    r3 = svc.submit("carol", *_dummy(g, 20, 1))
    assert r3.status == "rejected" and "bucket" in r3.reason
    assert svc.end_session("alice")
    assert svc.submit("bob", *_dummy(g, 8, 1)).ok


def test_killed_session_releases_arena_reservation():
    g = ZOO["lenet5"]()
    inj = FaultInjector()
    svc = _service(g, buckets=(8,), max_live_sessions=2, config=CFG,
                   injector=inj)
    assert svc.submit("alice", *_dummy(g, 8, 0)).ok
    assert svc.submit("bob", *_dummy(g, 8, 1)).ok
    reserved = svc.admission.reserved_bytes
    assert reserved == 2 * svc.admission.arena_share_bytes
    inj.arm_kill("session:alice")
    svc.enqueue("alice", *_dummy(g, 8, 2))
    svc.enqueue("carol", *_dummy(g, 8, 3))
    results = svc.drain()
    assert results[0].status == "killed" and "released" in results[0].reason
    assert inj.fired == ["session:alice"]
    assert results[1].ok
    assert svc.admission.reserved_bytes == reserved
    assert "alice" not in svc.servable.sessions
    assert svc.stats.killed == 1


# ---------------------------------------------------------------------------
# Shared plans + per-session state
# ---------------------------------------------------------------------------

def test_sessions_share_base_but_diverge_personally():
    """The base tree is never written: a trained session diverges from it,
    an untrained one holds private copies equal to it."""
    g = ZOO["lenet5"]()
    sv = ServablePersonalizer(g, lr=0.02, device="cpu")
    base = {o: {k: w.clone() for k, w in e.items()}
            for o, e in sv.base_params.items()}
    cp = compile_plan(g, CFG, batch=8)
    a = sv.open_session("a", cp.peak_bytes)
    b = sv.open_session("b", cp.peak_bytes)
    x, y = _dummy(g, 8, 0)
    sv.train_step(a, cp, x, y)
    for owner in sv.trainable_owners:
        for k, w in sv.base_params[owner].items():
            assert torch.equal(w, base[owner][k])
            assert torch.equal(b.params[owner][k], w)
            assert b.params[owner][k].data_ptr() != w.data_ptr()
            assert not torch.allclose(a.params[owner][k], w)
    assert a.step == 1 and b.step == 0
    assert sv.personal_bytes(a) == 2 * sv.personal_bytes(b)
    losses = [sv.train_step(a, cp, x, y)[0] for _ in range(10)]
    assert losses[-1] < losses[0]


@functools.lru_cache(maxsize=None)
def _reference_acceptance():
    """The reference's FIFO service on the acceptance traffic (lenet5, 8
    users over buckets (8, 16)): its base params, per-user grads and
    report."""
    jg = jzoo.ZOO["lenet5"]()
    svc = JService(jg, buckets=(8, 16), max_live_sessions=8,
                   config=jplan.MemoryPlanConfig(**CFG_KW),
                   interleave=False)
    svc.warmup()
    grads = []
    _record_grads(svc, grads)
    for u in range(8):
        x, y = _batch(jg, 6 if u % 2 else 14, u)
        assert svc.submit(f"u{u}", jnp.asarray(x), jnp.asarray(y)).ok
    return svc, dict(grads), svc.report()


def test_acceptance_eight_sessions_two_buckets():
    """8 concurrent sessions over 2 buckets share compiled plans (the
    reference's hit rate), every peak stays within its share, every plan
    passed the verifier, and every session's grads equal the reference
    service's on the same traffic."""
    jsvc, jgrads, jrep = _reference_acceptance()
    g = ZOO["lenet5"]()
    svc = _service(g, buckets=(8, 16), max_live_sessions=8, config=CFG)
    _share_base(svc, jsvc)
    svc.warmup()
    grads = []
    _record_grads(svc, grads)
    for u in range(8):
        x, y = _batch(g, 6 if u % 2 else 14, u)
        svc.enqueue(f"u{u}", *_t(x, y))
    for res in svc.drain():
        assert res.ok, res.reason
        assert res.peak_bytes <= res.arena_share_bytes
    rep = svc.report()
    assert rep["serve"]["completed"] == 8
    assert rep["plan_cache"] == jrep["plan_cache"]
    assert rep["plan_cache"]["hits"] >= 6
    assert all(s["within_share"] for s in rep["serve"]["sessions"].values())
    assert rep["scheduler"]["verify_errors"] == 0
    for cp in svc.cache._plans.values():
        assert cp.verify_report is not None and cp.verify_report.ok
    assert sorted(u for u, _ in grads) == sorted(jgrads)
    for user, got in grads:
        _assert_grads({k: {n: torch.from_numpy(v) for n, v in e.items()}
                       for k, e in got.items()}, jgrads[user])


def test_tight_budget_squeezes_plans_or_rejects():
    g = ZOO["lenet5"]()
    base = compile_plan(g, MemoryPlanConfig(swap=False), batch=8)
    share = int(base.peak_bytes * 0.9)
    svc = _service(g, buckets=(8,), max_live_sessions=2,
                   device_budget_bytes=2 * share, config=CFG)
    svc.warmup()
    res = svc.submit("a", *_dummy(g, 8, 0))
    assert res.ok and res.arena_share_bytes == share
    assert res.peak_bytes <= share
    with pytest.raises(ArenaBudgetError):
        _service(g, buckets=(8,), max_live_sessions=2,
                 device_budget_bytes=2 << 10, config=CFG).warmup()


def test_interleaved_service_matches_fifo_numerics():
    """The interleaved drain is an execution-order optimization only: the
    same traffic gives the FIFO drain's losses and session params."""
    g = ZOO["lenet5"]()
    out = {}
    for interleave in (False, True):
        svc = _service(g, buckets=(8,), max_live_sessions=3, config=CFG,
                       interleave=interleave)
        svc.warmup()
        for step in range(2):
            for u in range(3):
                svc.enqueue(f"u{u}", *_dummy(g, 8, 10 * step + u))
        out[interleave] = (svc.drain(), svc.servable.sessions)
    for fifo, inter in zip(out[False][0], out[True][0]):
        assert fifo.ok and inter.ok and fifo.user == inter.user
        np.testing.assert_allclose(inter.loss, fifo.loss, rtol=1e-5,
                                   atol=1e-6)
    for u, sess in out[False][1].items():
        for o, e in sess.params.items():
            for k, w in e.items():
                np.testing.assert_allclose(
                    out[True][1][u].params[o][k].numpy(), w.numpy(),
                    rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("interleave", [False, True])
def test_drains_run_deterministic_cudnn_and_return_float_losses(
        interleave):
    """Both drains run their steps under cuDNN's deterministic algorithms
    and put the caller's setting back; the results carry float losses."""
    g = ZOO["lenet5"]()
    svc = _service(g, buckets=(8,), max_live_sessions=2, config=CFG,
                   interleave=interleave)
    svc.warmup()
    seen = []
    apply = svc.servable.apply_update

    def recording(sess, grads):
        seen.append(torch.backends.cudnn.deterministic)
        apply(sess, grads)
    svc.servable.apply_update = recording
    was = torch.backends.cudnn.deterministic
    for u in range(2):
        svc.enqueue(f"u{u}", *_dummy(g, 8, u))
    results = svc.drain()
    assert seen == [True, True]
    assert torch.backends.cudnn.deterministic == was
    assert all(r.ok and type(r.loss) is float for r in results)
    assert all(type(s.last_loss) is float
               for s in svc.stats.sessions.values())


def test_service_queue_wait_and_deterministic_tie_break():
    g = ZOO["lenet5"]()
    svc = _service(g, buckets=(8,), max_live_sessions=4, config=CFG)
    svc.warmup()
    for u in ("w", "x", "y", "z"):
        svc.enqueue(u, *_dummy(g, 8, ord(u)))
    results = svc.drain()
    assert [r.user for r in results] == ["w", "x", "y", "z"]
    for r in results:
        assert r.ok and r.queue_wait_s >= 0.0
    rep = svc.report()["serve"]
    assert rep["queue_wait_s_total"] >= 0.0
    q = rep["by_qos"]["standard"]
    assert q["completed"] == 4
    assert q["queue_wait_s_total"] >= q["queue_wait_high_water_s"] >= 0.0
    for u in ("w", "x", "y", "z"):
        svc.enqueue(u, *_dummy(g, 8, ord(u)))
    assert [r.user for r in svc.drain()] == ["w", "x", "y", "z"]


def test_service_with_qos_classes_end_to_end():
    g = ZOO["lenet5"]()
    svc = _service(g, buckets=(8,), max_live_sessions=3, config=CFG,
                   qos=(QosClass("premium", weight=2.0, slots=1),
                        QosClass("standard", weight=1.0, slots=2)))
    svc.warmup()
    assert svc.admission.share_for("premium") \
        > svc.admission.share_for("standard")
    rp = svc.submit("p", *_dummy(g, 8, 0), qos="premium")
    rs = svc.submit("s", *_dummy(g, 8, 1), qos="standard")
    assert rp.ok and rs.ok
    assert rp.qos == "premium" and rs.qos == "standard"
    assert rp.arena_share_bytes > rs.arena_share_bytes
    assert rp.peak_bytes <= rp.arena_share_bytes
    assert rs.peak_bytes <= rs.arena_share_bytes
    with pytest.raises(KeyError):
        svc.enqueue("q", *_dummy(g, 8, 2), qos="gold")


# ---------------------------------------------------------------------------
# Optimizer-offload accounting
# ---------------------------------------------------------------------------

def test_serve_derives_optim_accounting_like_the_reference():
    """With offloaded moments the share shrinks against the all-resident
    one; the accounting equals the reference's for the same plans."""
    g = ZOO["lenet5"]()
    cfg = MemoryPlanConfig(optim_offload=True, **CFG_KW)
    svc = _service(g, buckets=(8,), max_live_sessions=4, config=cfg)
    svc.warmup()
    acct = svc.report()["optim_offload"]
    assert acct["share_bytes"] < acct["share_resident_bytes"]
    assert acct["sessions_in_resident_arena"] >= 4
    assert acct["sessions_per_arena_x"] >= 1.0
    assert acct["optim_device_bytes"] < acct["optim_resident_bytes"]
    # the reference's derivation over its own probes (no replay needed)
    jsvc = JService(jzoo.ZOO["lenet5"](), buckets=(8,), max_live_sessions=4,
                    config=jplan.MemoryPlanConfig(optim_offload=True,
                                                  **CFG_KW))
    probes = {8: jplan.compile_plan(jsvc.graph, jsvc.config, batch=8)}
    needed = probes[8].peak_bytes + probes[8].optim_device_bytes
    assert acct == jsvc._derive_optim_accounting(probes, needed)
    # the replay carried the optimizer ops
    res = svc.submit("a", *_dummy(g, 8, 0))
    assert res.ok and res.peak_bytes <= res.arena_share_bytes
    svc_plain = _service(g, buckets=(8,), max_live_sessions=2, config=CFG)
    svc_plain.warmup()
    assert "optim_offload" not in svc_plain.report()


# ---------------------------------------------------------------------------
# FaultInjector and the CLI
# ---------------------------------------------------------------------------

def test_fault_injector_counts_down_and_fires_once():
    inj = FaultInjector()
    inj.arm_kill("session:x", after=2)
    assert not inj.check("session:x")
    assert not inj.check("session:y")
    assert not inj.check("session:x")
    assert inj.check("session:x")
    assert not inj.check("session:x")
    assert inj.fired == ["session:x"]
    assert inj.armed == ()


def test_personalize_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    out = tmp_path / "stats.json"
    monkeypatch.setattr("sys.argv", [
        "serve", "personalize", "--model", "lenet5", "--users", "3",
        "--steps", "2", "--buckets", "4,8", "--max-live", "3",
        "--kill-user", "1", "--kill-after", "1", "--device", "cpu",
        "--json", str(out)])
    cli.main()
    text = capsys.readouterr().out
    assert "warmup: 2 buckets" in text and "interleaved drain" in text
    rep = json.loads(out.read_text())
    assert rep["model"] == "lenet5" and rep["buckets"] == [4, 8]
    assert rep["serve"]["completed"] == 5 and rep["serve"]["killed"] == 1
    assert rep["scheduler"]["cross_hidden_clock"] == "host"
    assert rep["driver"] == {"users": 3, "steps": 2, "device": "cpu",
                             "wall_time_s": rep["driver"]["wall_time_s"]}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")


def test_serve_entry_points_refuse_to_run_without_a_card(no_card,
                                                         monkeypatch):
    g = ZOO["lenet5"]()
    with pytest.raises(RuntimeError, match="CUDA"):
        PersonalizationService(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        dummy_batch(g, 4)
    monkeypatch.setattr("sys.argv", ["serve", "personalize"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main()
    assert init_params(g, torch.Generator(), device="cpu")
