"""The training path's kernels on the card: the flash and SwiGLU backwards
against their plain twins (flash also at Sq != Skv, as cross-attention
calls it), the SSD and mLSTM scans' Functions against autograd through
``ssd_chunked`` and ``mlstm_chunked``, and one train step of a reduced
model (dense, MoE, hybrid, xLSTM, and the multimodal families) with the
kernels against the same step with the twins in their place.

Needs a CUDA card (sm_90a); every case skips without one.  This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_train.py -m cuda
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as W  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402


# a per-layer budget under which the reduced plans below, with DMA priced
# cheap, offload tags (llama: all three; granite: qkv and attn_out)
OFFLOAD_BUDGET = 2 * 256 * 64 * 2 * 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sm_90a kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _leaves(shapes, dtype, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            .requires_grad_() for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_matches_the_twin(cuda_device, dtype, tol, causal):
    """dq, dk, dv of the wrapper (kernel forward, blockwise recompute
    backward) against autograd through the kernel's plain twin, GQA 3:1,
    normwise (fp32 1e-4, bf16 2e-2)."""
    q, k, v = _leaves([(2, 300, 6, 64), (2, 300, 2, 64), (2, 300, 2, 64)],
                      dtype, cuda_device, 0)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    before = K.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, causal=causal, block_q=64,
                                    block_kv=128)
    assert K.LAUNCHES == before + 1
    got = torch.autograd.grad(out, (q, k, v), do)
    twin = K.flash_attention_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, block_q=64, block_kv=128).transpose(1, 2)
    want = torch.autograd.grad(twin, (q, k, v), do)
    assert _rel(out, twin) <= tol
    for g, w in zip(got, want):
        assert g.dtype == dtype and _rel(g, w) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("sq,skv", [(300, 200), (200, 300)])
def test_cross_flash_backward_matches_the_twin(cuda_device, dtype, tol, sq,
                                               skv):
    """Cross-attention (non-causal, Sq != Skv, both ragged against the
    64-row tiles): dq, dk, dv of the wrapper against autograd through the
    kernel's plain twin, GQA 3:1, normwise."""
    q, k, v = _leaves([(2, sq, 6, 64), (2, skv, 2, 64), (2, skv, 2, 64)],
                      dtype, cuda_device, 4)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    before = K.LAUNCHES
    out = flash_ops.flash_attention(q, k, v, causal=False, block_q=64,
                                    block_kv=128)
    assert K.LAUNCHES == before + 1
    got = torch.autograd.grad(out, (q, k, v), do)
    twin = K.flash_attention_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=False, block_q=64, block_kv=128).transpose(1, 2)
    want = torch.autograd.grad(twin, (q, k, v), do)
    assert _rel(out, twin) <= tol
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape and _rel(g, w) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shapes", [
    [(256, 192), (192, 320), (192, 320)],                # dense MLP
    [(4, 96, 128), (4, 128, 64), (4, 128, 64)],          # the experts
])
def test_swiglu_backward_matches_the_twin(cuda_device, dtype, tol, shapes):
    """x, wg, wu grads of the wrapper (kernel forward, the twin's autograd
    backward; tf32 products for bf16) against autograd through the twin."""
    x, wg, wu = _leaves(shapes, dtype, cuda_device, 1)
    before = W.LAUNCHES
    h = W.fused_swiglu(x, wg, wu)
    assert W.LAUNCHES == before + 1
    dh = torch.randn(h.shape, device=cuda_device).to(dtype)
    got = torch.autograd.grad(h, (x, wg, wu), dh)
    want = torch.autograd.grad(W.fused_swiglu_plain(x, wg, wu),
                               (x, wg, wu), dh)
    for g, w in zip(got, want):
        assert g.dtype == dtype and _rel(g, w) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 300])
def test_ssd_scan_backward_matches_the_plain_path(cuda_device, s):
    """``ssd_scan``'s Function (the wgmma kernel forward, the vjp of
    ``ssd_chunked`` backward) against autograd through ``ssd_chunked``
    itself on the card: the output and all five grads normwise within 1e-4
    in fp32, at 64-wide heads and state (the wgmma kernel's widths)."""
    from repro_torch.kernels.ssm_scan import kernel as S
    from repro_torch.kernels.ssm_scan.ops import ssd_scan
    from repro_torch.models.ssm import ssd_chunked

    x, B, C = _leaves([(1, s, 4, 64), (1, s, 64), (1, s, 64)],
                      torch.float32, cuda_device, 3)
    dt = torch.nn.functional.softplus(
        torch.randn(1, s, 4, device=cuda_device)).requires_grad_()
    A_log = torch.log(torch.linspace(1.0, 16.0, 4, device=cuda_device)) \
        .requires_grad_()
    ins = (x, dt, A_log, B, C)
    dy = torch.randn(x.shape, device=cuda_device)
    before = S.LAUNCHES_BY_VARIANT["wgmma"]
    y = ssd_scan(*ins)
    assert S.LAUNCHES_BY_VARIANT["wgmma"] == before + 1
    got = torch.autograd.grad(y, ins, dy)
    plain = ssd_chunked(*ins)
    want = torch.autograd.grad(plain, ins, dy)
    assert _rel(y, plain) <= 1e-4
    for g, w in zip(got, want):
        assert bool(g.isfinite().all()) and _rel(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s", [256, 300])
def test_mlstm_scan_backward_matches_the_plain_path(cuda_device, s):
    """``mlstm_scan``'s Function (the wgmma kernel forward, the vjp of
    ``mlstm_chunked`` backward) against autograd through
    ``mlstm_chunked`` itself on the card: the output and all five grads
    normwise within 1e-4 in fp32, at head dim 128."""
    from repro_torch.kernels.mlstm_scan import kernel as M
    from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
    from repro_torch.models.xlstm import mlstm_chunked

    q, k, v, ig = _leaves([(1, s, 2, 128)] * 3 + [(1, s, 2)],
                          torch.float32, cuda_device, 4)
    fg = (torch.randn(1, s, 2, device=cuda_device) + 3.0).requires_grad_()
    ins = (q, k, v, ig, fg)
    dy = torch.randn(q.shape, device=cuda_device)
    before = M.LAUNCHES_BY_VARIANT["wgmma"]
    y = mlstm_scan(*ins)
    assert M.LAUNCHES_BY_VARIANT["wgmma"] == before + 1
    got = torch.autograd.grad(y, ins, dy)
    plain = mlstm_chunked(*ins)
    want = torch.autograd.grad(plain, ins, dy)
    assert _rel(y, plain) <= 1e-4
    for g, w in zip(got, want):
        assert bool(g.isfinite().all()) and _rel(g, w) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_recurrent_train_step_kernel_path_matches_plain_path(cuda_device,
                                                             arch,
                                                             monkeypatch):
    """The loss and every gradient of a reduced zamba2-7b (64-wide SSD heads
    and state) or xlstm-1.3b (head dim 128) at S = 300, fp32, remat on:
    the kernels against their twins in the wrappers' place, normwise
    within the larger of 1e-4 and twice a second plain path's distance
    from the twins on the leaf (the scans' forwards by ``ssd_chunked`` /
    ``mlstm_chunked``), as ``chip_smoke.py`` (g) holds zamba2-7b: the SSD
    decay leaves A_log and dt_bias sum cancelling terms, and their fp32
    grads move with the order of the sums."""
    from repro_torch.kernels.mlstm_scan import kernel as M
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.kernels.ssm_scan import kernel as S
    from repro_torch.kernels.ssm_scan import ops as ssd_ops
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.models.xlstm import mlstm_chunked

    widths = dict(d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
                  ssm_heads=8, ssm_state=64) if arch == "zamba2-7b" \
        else dict(d_model=256, n_heads=4)
    cfg = reduce_config(ARCHS[arch], vocab=512, dtype="float32",
                        attention_impl="pallas", block_q=64, block_kv=64,
                        remat=True, **widths)
    model = build_model(cfg)
    params = model.init(0, device=cuda_device, trainable=True)
    g = torch.Generator(cuda_device).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (1, 301), generator=g,
                         device=cuda_device)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def grads():
        for p in params.parameters():
            p.grad = None
        loss = model.loss_fn(params, batch)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in params.named_parameters()}

    S.reset_launches()
    M.reset_launches()
    loss, got = grads()
    assert S.LAUNCHES_BY_VARIANT["simt"] == M.LAUNCHES_BY_VARIANT["simt"] == 0
    assert S.LAUNCHES + M.LAUNCHES > 0
    monkeypatch.setattr(ssd_ops, "ssd_chunk", S.ssd_chunk_plain)
    monkeypatch.setattr(mlstm_ops, "mlstm_chunk", M.mlstm_chunk_plain)
    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        K.flash_attention_fwd_plain)
    monkeypatch.setattr(W, "_forward", W.fused_swiglu_plain)
    want_loss, want = grads()
    monkeypatch.setattr(ssd_ops, "_forward",
                        lambda *a: ssd_chunked(*a[:5], chunk=a[5]))
    monkeypatch.setattr(mlstm_ops, "_forward",
                        lambda *a: mlstm_chunked(*a[:5], chunk=a[5]))
    _, other = grads()
    assert _rel(loss, want_loss) <= 1e-4
    for name, w in want.items():
        tol = max(1e-4, 2 * _rel(other[name], w))
        assert _rel(got[name], w) <= tol, (name, _rel(got[name], w), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_train_step_kernel_path_matches_plain_path(cuda_device, arch,
                                                   monkeypatch):
    """One fp32 AdamW step of a reduced model (2 layers, head dim 64, S =
    256 > block_q), every tag recomputed: the kernels (simt) against the
    twins in the wrappers' place, the loss, grad norm and every gradient
    normwise within 1e-4 (the parameters after the step are not compared:
    Adam turns a near-zero gradient's 1e-7 difference into a step)."""
    cfg = reduce_config(ARCHS[arch], n_layers=2, d_model=256, n_heads=4,
                        n_kv_heads=2, head_dim=64, d_ff=512, vocab=512,
                        attention_impl="pallas", block_q=64, block_kv=64,
                        dtype="float32", remat=True, remat_budget_bytes=0)
    model = build_model(cfg)
    g = torch.Generator(cuda_device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (2, 257), generator=g,
                         device=cuda_device)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def step():
        params = model.init(0, device=cuda_device, trainable=True)
        opt = make_optimizer("adamw", lr=1e-3)
        state = opt.init(dict(params.named_parameters()))
        bundle = make_train_step(model, opt, ShapeConfig("t", 256, 2,
                                                         "train"))
        params, _, metrics = bundle.fn(params, state, batch)
        return params, metrics

    K.reset_launches()
    W.reset_launches()
    got, got_m = step()
    assert K.LAUNCHES_BY_VARIANT["simt"] == 2 * cfg.n_layers
    assert W.LAUNCHES_BY_VARIANT["simt"] == 2 * cfg.n_layers
    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        K.flash_attention_fwd_plain)
    monkeypatch.setattr(W, "_forward", W.fused_swiglu_plain)
    want, want_m = step()
    for key in ("loss", "grad_norm"):
        assert _rel(got_m[key], want_m[key]) <= 1e-4, key
    want_p = dict(want.named_parameters())
    for name, p in got.named_parameters():
        assert _rel(p.grad, want_p[name].grad) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_offload_on_the_card_matches_keep_all(cuda_device, arch):
    """Two fp32 AdamW steps of a reduced model whose plan offloads tags to
    pinned host memory (copied on the copy stream, fenced before the
    backward reads them) against the same steps under the keep-all plan:
    each step's loss and every gradient normwise within 1e-6 (the same
    function).  Between each forward and its backward, blocks of the sizes
    of the released device copies are filled with NaN, so a copy that
    raced the compute stream, or a fetch that read freed memory, shows;
    every fetched copy is fenced once."""
    from repro_torch.core import remat
    from repro_torch.core.plan import compile_plan

    base = reduce_config(ARCHS[arch], n_layers=2, d_model=256, n_heads=4,
                         n_kv_heads=2, head_dim=64, d_ff=512, vocab=512,
                         attention_impl="pallas", block_q=64, block_kv=64,
                         dtype="float32", remat=True)
    offload = dataclasses.replace(base, offload=True, dma_gbps=1e6,
                                  remat_budget_bytes=OFFLOAD_BUDGET)
    decisions = compile_plan(offload, batch_tokens=512).remat_plan \
        .decisions()
    assert "offload" in decisions.values()
    g = torch.Generator(cuda_device).manual_seed(3)
    toks = torch.randint(0, base.vocab, (2, 2, 257), generator=g,
                         device=cuda_device)

    def two_steps(cfg, scribble):
        model = build_model(cfg)
        params = model.init(0, device=cuda_device, trainable=True)
        named = dict(params.named_parameters())
        opt = make_optimizer("adamw", lr=1e-3)
        state = opt.init(named)
        out = []
        for t in toks:
            with remat.observe_regions() as stats:
                loss = model.loss_fn(params, {"tokens": t[:, :-1],
                                              "targets": t[:, 1:]})
            if scribble:
                junk = [torch.full((n // 4,), float("nan"),
                                   device=cuda_device)
                        for s in stats for n in s.offloaded.values()]
                del junk
            loss.backward()
            grads = {n: p.grad.detach().clone() for n, p in named.items()}
            opt.update_(grads, state, named)
            for p in named.values():
                p.grad = None
            torch.cuda.synchronize()
            out.append((loss.detach(), grads, stats))
        return out

    want = two_steps(base, False)
    got = two_steps(offload, True)
    for (loss, grads, stats), (wloss, wgrads, _) in zip(got, want):
        assert _rel(loss, wloss) <= 1e-6
        for name, w in wgrads.items():
            assert _rel(grads[name], w) <= 1e-6, name
        assert all(s.offloaded and len(s.fences) == len(s.offloaded)
                   for s in stats)
        assert remat.fence_wait_ms(stats) >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_multimodal_train_step_kernel_path_matches_plain_path(cuda_device,
                                                              arch,
                                                              monkeypatch):
    """One fp32 AdamW step of a reduced multimodal model (head dim 64, S =
    256 > block_q, 200 image tokens or encoder frames, every xgate 0.5),
    every tag recomputed: the kernels (simt) in every self- and
    cross-attention and MLP, forward and replay, against the twins in the
    wrappers' place; the loss, grad norm and every gradient normwise
    within 1e-4, the cross-attentions' and whisper's encoder grads
    non-zero."""
    vlm = arch == "llama-3.2-vision-11b"
    extra = dict(image_tokens=200) if vlm else dict(encoder_seq=200)
    cfg = reduce_config(ARCHS[arch], d_model=256, n_heads=4, n_kv_heads=2,
                        head_dim=64, d_ff=512, vocab=512,
                        attention_impl="pallas", block_q=64, block_kv=64,
                        dtype="float32", remat=True, remat_budget_bytes=0,
                        **extra)
    model = build_model(cfg)
    g = torch.Generator(cuda_device).manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (2, 257), generator=g,
                         device=cuda_device)
    key, t = ("image_embeds", cfg.image_tokens) if vlm \
        else ("enc_frames", cfg.encoder_seq)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             key: torch.randn((2, t, cfg.d_model), generator=g,
                              device=cuda_device)}

    def step():
        params = model.init(0, device=cuda_device, trainable=True)
        for p in (params.cross_blocks if vlm else params.dec_blocks):
            p.xgate.data.fill_(0.5)
        opt = make_optimizer("adamw", lr=1e-3)
        state = opt.init(dict(params.named_parameters()))
        bundle = make_train_step(model, opt, ShapeConfig("t", 256, 2,
                                                         "train"))
        params, _, metrics = bundle.fn(params, state, batch)
        return params, metrics

    K.reset_launches()
    W.reset_launches()
    got, got_m = step()
    if vlm:
        n_flash = cfg.n_layers + cfg.n_layers // cfg.cross_attn_every
        n_mlp = cfg.n_layers
    else:
        n_flash = cfg.encoder_layers + 2 * cfg.n_layers
        n_mlp = cfg.encoder_layers + cfg.n_layers
    assert K.LAUNCHES == K.LAUNCHES_BY_VARIANT["simt"] == 2 * n_flash
    assert W.LAUNCHES == W.LAUNCHES_BY_VARIANT["simt"] == 2 * n_mlp
    monkeypatch.setattr(flash_ops, "flash_attention_fwd",
                        K.flash_attention_fwd_plain)
    monkeypatch.setattr(W, "_forward", W.fused_swiglu_plain)
    want, want_m = step()
    for name in ("loss", "grad_norm"):
        assert _rel(got_m[name], want_m[name]) <= 1e-4, name
    want_p = dict(want.named_parameters())
    for name, p in got.named_parameters():
        assert _rel(p.grad, want_p[name].grad) <= 1e-4, name
        if ".xattn." in name or name.startswith("enc_"):
            assert bool(p.grad.abs().max() > 0), name
