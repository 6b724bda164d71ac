"""The paper path's CUDA transfer engine on the card: the pinned host pool
and its planned offsets, ``record_stream`` keeping a swapped-out source
alive until its copy lands, prefetched alias groups as views of one
buffer, and the ``async`` backend (the copy stream) against ``sim`` on two
zoo graphs.

Needs a CUDA card; every case skips without one.  This file imports no
JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_core.py -m cuda
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.exec import (AsyncDeviceBackend,  # noqa: E402
                                   DeviceStreamEngine)
from repro_torch.core.exec.layers import reference_loss_and_grads  # noqa
from repro_torch.core.exec.store import HostPool, SwapExecStats  # noqa: E402
from repro_torch.core.plan import MemoryPlanConfig, compile_plan  # noqa
from repro_torch.core.zoo import ZOO  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the copy stream has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_pool_is_pinned_and_slots_sit_at_planned_offsets(cuda_device):
    pool = HostPool(cuda_device)
    pool.reserve(1 << 20)
    assert pool.buf.is_pinned() and pool.buf.numel() == 1 << 20
    eng = DeviceStreamEngine(cuda_device, pool=pool)
    x = torch.randn(256, 256, device=cuda_device)
    members = {"conv": x, "act": x, "flat": x.reshape(-1)}
    host = eng.swap_out("X:conv", members, x.numel() * 4, host_offset=4096)
    torch.cuda.synchronize()
    assert len({id(h.buf) for h in host.values()}) == 1
    slot = pool.buf[4096:4096 + x.numel() * 4].view(torch.float32)
    assert torch.equal(slot, x.reshape(-1).cpu())
    back = eng.swap_in("X:conv", host, x.numel() * 4)
    stats = SwapExecStats()
    eng.fence("X:conv", stats)
    eng.drain(stats)
    assert back["act"].is_cuda
    assert back["conv"].data_ptr() == back["act"].data_ptr() \
        == back["flat"].data_ptr()
    assert torch.equal(back["act"], x)
    assert stats.fences == 1 and eng.inflight_bytes == 0


@pytest.mark.cuda
def test_record_stream_keeps_a_swapped_source_alive(cuda_device):
    """Hold the copy back behind a long kernel, drop the source and ask
    for a block of its size at once: the allocator must not hand out the
    source's block before the copy has read it."""
    n = 1 << 22
    pool = HostPool(cuda_device)
    pool.reserve(n * 4)
    eng = DeviceStreamEngine(cuda_device, pool=pool)
    x = torch.randn(n, device=cuda_device)
    want = x.cpu()
    ptr = x.data_ptr()
    torch.cuda._sleep(200_000_000)         # the producer "runs" ~0.1 s
    eng.swap_out("X:a", {"a": x}, n * 4, host_offset=0)
    del x
    y = torch.full((n,), -7.0, device=cuda_device)
    assert y.data_ptr() != ptr
    torch.cuda.synchronize()
    assert torch.equal(pool.buf.view(torch.float32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lenet5", "resnet18"])
def test_async_matches_sim_on_the_card(cuda_device, name):
    g = ZOO[name]()
    cp = compile_plan(g, MemoryPlanConfig(min_idle_phases=3,
                                          min_bytes=1 << 12), batch=16)
    assert cp.lowered.transfers()
    params = cp.init_params(torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(1)
    x = torch.randn((16,) + tuple(g.input_shape), generator=gen,
                    device=cuda_device)
    y = torch.nn.functional.one_hot(
        torch.randint(0, 10, (16,), generator=gen, device=cuda_device),
        10).float()
    _, ref = reference_loss_and_grads(g, params, x, y)
    runs = {}
    for executor in ("sim", AsyncDeviceBackend()):
        loss, grads, stats = cp.loss_and_grads(params, x, y,
                                               executor=executor)
        assert stats.replayed_ops == cp.lowered.ops
        assert stats.late_swap_ins == 0
        for k in ref:
            for n, want in ref[k].items():
                scale = max(1.0, want.abs().max().item())
                assert ((grads[k][n] - want).abs()
                        <= 1e-5 * scale + 1e-4 * want.abs()).all(), (k, n)
        runs[stats.backend] = stats
    sim, asy = runs["sim"], runs["async"]
    for field in ("swap_outs", "prefetches", "inplace_prefetches",
                  "dma_bytes", "hbm_high_water", "host_high_water",
                  "peak_inflight_prefetch"):
        assert getattr(sim, field) == getattr(asy, field), field
    assert asy.fences == asy.prefetches > 0
    assert 0.0 <= asy.achieved_overlap <= 1.0
    assert asy.hidden_dma_s >= 0.0 and asy.exposed_dma_s >= 0.0
