"""The optimizer lane and the personalization service on the card: the
optimizer prefetch as a real H2D copy from the pinned pool on the copy
stream and its fence, ``offloaded_update`` on the card against the same
code on the CPU, the replay's own update (its prefetches moving the
runtime's pinned copies) against ``offloaded_update``, an interleaved
drain of three sessions against autograd, and a kill that releases its
reservation.

Needs a CUDA card; every case skips without one.  This file imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_serve.py -m cuda
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.exec import DeviceStreamEngine  # noqa: E402
from repro_torch.core.exec.layers import reference_loss_and_grads  # noqa
from repro_torch.core.exec.store import (HostPool, SessionScopedEngine,  # noqa
                                         SwapExecStats)
from repro_torch.core.optim_offload import (OffloadedStep,  # noqa: E402
                                            OptimRuntime, offloaded_update)
from repro_torch.core.plan import MemoryPlanConfig, compile_plan  # noqa
from repro_torch.core.zoo import ZOO  # noqa: E402
from repro_torch.runtime.fault import FaultInjector  # noqa: E402
from repro_torch.serve import PersonalizationService  # noqa: E402
from repro_torch.serve.buckets import dummy_batch  # noqa: E402

torch.set_num_threads(1)

CFG_KW = dict(min_idle_phases=3, min_bytes=1 << 12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the copy stream has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grads_close(got, want, rtol=1e-4, atol=1e-5, norm=1e-4):
    for k in want:
        for n, b in want[k].items():
            a = got[k][n]
            top = max(1.0, b.abs().max().item())
            assert torch.allclose(a, b, rtol=rtol, atol=atol * top), (k, n)
            assert (a - b).abs().max().item() <= norm * top, (k, n)


@pytest.mark.cuda
def test_opt_prefetch_is_a_real_h2d_fenced_on_the_card(cuda_device):
    opt_pool = HostPool(cuda_device)
    eng = DeviceStreamEngine(cuda_device, opt_pool=opt_pool)
    eng.reserve(0, 1 << 20)
    assert opt_pool.buf.is_pinned()
    scoped = SessionScopedEngine(eng, "a")
    scoped.reserve(0, 1 << 20)
    stats = SwapExecStats()
    eng.opt_swap_in("O:l", 1 << 21, 1 << 19, stats, host_offset=4096)
    scoped.opt_swap_in("O:l", 1 << 21, 1 << 19, stats, host_offset=0)
    assert eng.opt_inflight_bytes == 2 << 19
    copy = eng._opt_inflight["O:l"]
    assert copy.done is not None and copy.start is not None
    eng.opt_fence("O:l", stats)
    scoped.drain(stats)
    assert stats.opt_fences == 2 and eng.opt_inflight_bytes == 0
    # measured on the card's clock once the shared engine settles
    eng.settle()
    assert stats.opt_hidden_dma_s + stats.opt_exposed_dma_s > 0.0
    assert stats.opt_stalled_fences <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_offloaded_update_on_the_card_matches_the_cpu(cuda_device,
                                                      compress):
    g = ZOO["lenet5"]()
    cp = compile_plan(g, MemoryPlanConfig(optim_offload=True,
                                          optim_compress=compress, **CFG_KW),
                      batch=8)
    params = cp.init_params(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    grads = [{k: {n: torch.randn(w.shape, generator=gen)
                  for n, w in e.items()} for k, e in params.items()}
             for _ in range(3)]
    rt_gpu = OptimRuntime(cp.optim_plan, g, device=cuda_device)
    rt_cpu = OptimRuntime(cp.optim_plan, g, device="cpu")
    assert rt_gpu.host_buf.is_pinned()
    p_gpu = {k: {n: w.to(cuda_device) for n, w in e.items()}
             for k, e in params.items()}
    p_cpu = params
    for gr in grads:
        stats = SwapExecStats()
        p_gpu = offloaded_update(rt_gpu, p_gpu, {
            k: {n: v.to(cuda_device) for n, v in e.items()}
            for k, e in gr.items()}, stats)
        p_cpu = offloaded_update(rt_cpu, p_cpu, gr)
        assert stats.opt_dma_bytes == cp.optim_plan.dma_bytes_per_step
    err = max((p_gpu[k][n].cpu() - p_cpu[k][n]).abs().max().item()
              for k in p_cpu for n in p_cpu[k])
    # uncompressed: float noise; compressed: an ulp of the card's exp may
    # move an int8 entry across a rounding tie, which moves that weight's
    # next update by less than lr (3e-4)
    assert err <= (1e-6 if not compress else rt_cpu.lr), err
    assert all(v > 0.0 for k, v in rt_gpu.timings.items()
               if k != "host_quantize_s" or compress)


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_replay_update_on_the_card_matches_offloaded_update(cuda_device,
                                                           compress):
    """The replay's optimizer ops move the runtime's pinned host copies
    on the copy stream and update at ``OptSwapOut``: the params that
    ``offloaded_update`` makes from the replay's grads, bit for bit."""
    g = ZOO["lenet5"]()
    cp = compile_plan(g, MemoryPlanConfig(optim_offload=True,
                                          optim_compress=compress,
                                          executor="async", **CFG_KW),
                      batch=8)
    params = cp.init_params(torch.Generator().manual_seed(0),
                            device=cuda_device)
    a = OptimRuntime(cp.optim_plan, g, device=cuda_device)
    b = OptimRuntime(cp.optim_plan, g, device=cuda_device)
    pa = pb = params
    for seed in range(3):
        x, y = dummy_batch(g, 8, seed=seed, device=cuda_device)
        step = OffloadedStep(a, pa)
        _, grads, stats = cp.loss_and_grads(pa, x, y, optim=step)
        pa = step.new_params
        pb = offloaded_update(b, pb, grads)
        assert stats.opt_fences == len(cp.optim_plan.slots)
    for k in pb:
        for n in pb[k]:
            assert torch.equal(pa[k][n], pb[k][n]), (k, n)
    assert all(v > 0.0 for k, v in a.timings.items()
               if k != "host_quantize_s" or compress)


@pytest.mark.cuda
def test_interleaved_drain_of_three_sessions_matches_autograd(cuda_device):
    g = ZOO["lenet5"]()
    svc = PersonalizationService(
        g, buckets=(8,), max_live_sessions=3,
        config=MemoryPlanConfig(executor="async", **CFG_KW))
    svc.warmup()
    grads = []
    apply = svc.servable.apply_update

    def recording(sess, gr):
        grads.append((sess.user, {k: {n: v.clone() for n, v in e.items()}
                                  for k, e in gr.items()}))
        apply(sess, gr)
    svc.servable.apply_update = recording
    batches = {f"u{u}": dummy_batch(g, 8, seed=u) for u in range(3)}
    params = {u: None for u in batches}
    for u, (x, y) in batches.items():
        svc.enqueue(u, x, y)
    # the params each session trains on: the shared base (no step yet)
    for u in batches:
        params[u] = svc.servable.base_params
    results = svc.drain()
    assert all(r.ok for r in results)
    rep = svc.report()["scheduler"]
    assert rep["cross_hidden_clock"] == "device"
    assert rep["verify_errors"] == 0 and rep["cross_hidden_dma_s"] >= 0.0
    for user, got in grads:
        x, y = batches[user]
        _, want = reference_loss_and_grads(g, params[user], x, y)
        _grads_close(got, want)


@pytest.mark.cuda
def test_kill_on_the_card_releases_its_reservation(cuda_device):
    g = ZOO["lenet5"]()
    inj = FaultInjector()
    svc = PersonalizationService(g, buckets=(8,), max_live_sessions=2,
                                 config=MemoryPlanConfig(**CFG_KW),
                                 injector=inj)
    svc.warmup()
    inj.arm_kill("session:bob", after=1)
    svc.enqueue("alice", *dummy_batch(g, 8, seed=0))
    svc.enqueue("bob", *dummy_batch(g, 8, seed=1))
    r_alice, r_bob = svc.drain()
    assert r_alice.ok and r_bob.status == "killed"
    assert "released" in r_bob.reason and "bob" not in svc.admission.live
    sched = svc._scheduler
    assert not sched.engine._inflight and not sched.engine._opt_inflight
    assert svc.submit("bob", *dummy_batch(g, 8, seed=2)).ok
