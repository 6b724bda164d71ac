"""The port's hand-written CUDA kernels against their plain PyTorch twins.

Needs a CUDA card (sm_90a); every case skips without one.  This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as W  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as M  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as S  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import (chunk_inputs,  # noqa: E402
                                              ssd_scan)
from repro_torch.models import moe  # noqa: E402

torch.set_num_threads(1)

FLASH_CASES = [
    # (b, hq, hkv, sq, skv, d, causal), the shapes of tests/test_kernels.py
    # plus the llama3.2-3b layer shape at a ragged length
    (1, 2, 2, 128, 128, 64, True),
    (2, 4, 2, 256, 256, 64, True),
    (1, 8, 1, 128, 128, 128, True),
    (1, 2, 2, 200, 200, 64, True),
    (1, 2, 2, 128, 256, 64, False),
    (2, 2, 2, 256, 256, 32, True),
    (1, 2, 2, 128, 256, 64, True),          # top-left causal, Sq != Skv
    (2, 24, 8, 1000, 1000, 128, True),
    (1, 2, 2, 200, 200, 112, True),         # zamba2-7b head dim
    (2, 32, 32, 1000, 1000, 112, True),     # its shared block, ragged
]

# cross-attention: Sq != Skv, non-causal, Skv ragged against the wgmma
# kernel's key tiles (128 keys at D 64, 96 at D 128): whisper-tiny's
# decoder against its 1500 frames, then llama-3.2-vision-11b's GQA cross
# call against 1600 image tokens, both with fewer heads, fewer keys than
# one tile, and more keys than queries
CROSS_CASES = [
    (2, 6, 6, 448, 1500, 64, False),
    (1, 4, 2, 300, 200, 64, False),
    (2, 8, 2, 1000, 1600, 128, False),
    (1, 8, 2, 100, 72, 128, False),
    (1, 4, 4, 130, 300, 128, False),
]

SSD_CASES = [
    # (b, s, h, p, n, chunk): tests/test_kernels.py, then zamba2-7b's mamba
    # layer at a ragged S and at B = 2, S = 4096
    (1, 64, 2, 16, 16, 32),
    (2, 128, 4, 32, 64, 64),
    (1, 100, 2, 16, 16, 32),
    (1, 32, 1, 64, 32, 32),
    (1, 300, 112, 64, 64, 256),
    (2, 4096, 112, 64, 64, 256),
]
SSD_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py:105

MLSTM_CASES = [
    # (b, s, h, p, chunk): tests/test_kernels.py:130, then xlstm-1.3b's
    # mLSTM layer (p = 1024, chunk 256) at a ragged S and at B = 2, S = 4096
    (1, 64, 2, 16, 32),
    (2, 128, 4, 32, 64),
    (1, 100, 2, 16, 32),
    (1, 32, 1, 64, 32),
    (1, 600, 4, 1024, 256),
    (2, 4096, 4, 1024, 256),
]
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_kernels.py:151

SWIGLU_CASES = [
    # (e, m, k, f): tests/test_kernels.py:175 (e = 1, a dense MLP), a batch
    # of ragged experts with an unaligned K, a decode step's M = 4, and
    # granite-moe-1b-a400m's experts at its prefill step (B = 2, S = 4096)
    (1, 128, 256, 512),
    (1, 256, 512, 256),
    (1, 100, 200, 300),
    (1, 64, 64, 64),
    (3, 70, 203, 37),
    (32, 4, 1024, 512),
    (32, 2560, 1024, 512),
]


def _tol(dtype):
    # tests/test_kernels.py:_tol
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sm_90a kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (variant, dtype): every kernel the flash wrapper can choose, in the
# dtypes it takes ("wgmma" is bf16 only)
FLASH_VARIANTS = [("simt", "float32"), ("simt", "bfloat16"),
                  ("wgmma", "bfloat16")]


def _flash_inputs(case, dt, device, seed=4):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(device, dt)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("variant, dtype", FLASH_VARIANTS)
def test_flash_kernel_matches_plain_twin(cuda_device, case, variant, dtype):
    """Each variant against the twin; the wrapper picks wgmma for bf16,
    simt for fp32, and counts the launch under it."""
    _flash_against_twin(cuda_device, case, variant, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CROSS_CASES)
@pytest.mark.parametrize("variant, dtype", FLASH_VARIANTS)
def test_flash_cross_attention_matches_plain_twin(cuda_device, case,
                                                  variant, dtype):
    """The multimodal cross-attention shapes (Sq != Skv, non-causal) in
    each variant against the twin."""
    _flash_against_twin(cuda_device, case, variant, dtype)


def _flash_against_twin(cuda_device, case, variant, dtype):
    causal = case[6]
    dt = getattr(torch, dtype)
    q, k, v = _flash_inputs(case, dt, cuda_device)
    before = dict(K.LAUNCHES_BY_VARIANT)
    got = K._launch(q, k, v, causal, variant)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BY_VARIANT[variant] == before[variant] + 1
    want = K.flash_attention_fwd_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dt))
    assert K.variant_for(q, k, v) == \
        ("wgmma" if dtype == "bfloat16" else "simt")


@pytest.mark.cuda
def test_flash_wgmma_and_simt_agree_at_a_path_shape(cuda_device):
    """zamba2-7b's shared attention (D = 112, padded to 128 by TMA's zero
    fill) at S = 2048: the two designs within the bf16 tolerance."""
    q, k, v = _flash_inputs((1, 32, 32, 2048, 2048, 112), torch.bfloat16,
                            cuda_device, seed=12)
    new = K._launch(q, k, v, True, "wgmma")
    old = K._launch(q, k, v, True, "simt")
    np.testing.assert_allclose(new.float().cpu().numpy(),
                               old.float().cpu().numpy(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_flash_kernel_reads_bshd_strides(cuda_device):
    """(B, S, H, D) tensors go in as transposed views and come out in the
    same layout, with no copy."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 300, 8, 64), np.float32)) \
        .to(cuda_device, torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((2, 300, 2, 64), np.float32)) \
        .to(cuda_device, torch.bfloat16)
    got = K.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                k.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    want = K.flash_attention_fwd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                       k.transpose(1, 2))
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_flash_kernel_rejects_unsupported_head_dim(cuda_device):
    q = torch.zeros(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError):
        K.flash_attention_fwd(q, q, q)


def _ssd_inputs(case, device, seed=6):
    b, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, s, h, p), np.float32),
              np.logaddexp(rng.standard_normal((b, s, h)), 0)
              .astype(np.float32),
              (rng.standard_normal(h) * 0.5).astype(np.float32),
              rng.standard_normal((b, s, n), np.float32),
              rng.standard_normal((b, s, n), np.float32))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _ssd_variant(case):
    """The SSD kernel the wrapper chooses: wgmma for n = p = 64 and whole
    64-row chunks up to 256, simt otherwise."""
    _, s, _, p, n, chunk = case
    q = min(chunk, s)
    return "wgmma" if p == n == 64 and q % 64 == 0 and q <= 256 else "simt"


def _with_simt(cases, variant_of):
    """(case, variant) for the variant the wrapper chooses and, beside a
    wgmma one, the earlier simt design forced."""
    return [(c, v) for c in cases
            for v in dict.fromkeys([variant_of(c), "simt"])]


@pytest.mark.cuda
@pytest.mark.parametrize("case, variant", _with_simt(SSD_CASES, _ssd_variant))
def test_ssd_kernel_matches_plain_twin(cuda_device, case, variant):
    """All three outputs: y_diag, states, chunk_lf, in every variant; the
    wrapper chooses the rule's variant and counts the launch under it."""
    x, dt, A_log, B, C = _ssd_inputs(case, cuda_device)
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, case[-1])
    assert S.variant_for(xc, dtc, A_log, Bc, Cc) == _ssd_variant(case)
    before = dict(S.LAUNCHES_BY_VARIANT)
    got = S._launch(xc, dtc, A_log, Bc, Cc, variant)
    torch.cuda.synchronize()
    assert S.LAUNCHES_BY_VARIANT[variant] == before[variant] + 1
    want = S.ssd_chunk_plain(xc, dtc, A_log, Bc, Cc)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(g.isfinite().all())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **SSD_TOL)


@pytest.mark.cuda
def test_ssd_scan_on_the_card_matches_the_cpu_path(cuda_device):
    """The whole chunked scan: kernel + recurrence on the card against the
    plain twin + recurrence on the CPU."""
    case = (2, 700, 8, 64, 64, 256)
    ins = _ssd_inputs(case, cuda_device, seed=7)
    got = ssd_scan(*ins)
    want = ssd_scan(*(t.cpu() for t in ins))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **SSD_TOL)


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    x, dt, A_log, B, C = _ssd_inputs((1, 64, 2, 16, 16, 32), cuda_device)
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, 32)
    with pytest.raises(ValueError):                    # n = 48
        S.ssd_chunk(xc, dtc, A_log, torch.zeros(1, 2, 32, 48,
                                                 device=cuda_device),
                    torch.zeros(1, 2, 32, 48, device=cuda_device))
    with pytest.raises(ValueError):                    # not contiguous
        S.ssd_chunk(xc.transpose(3, 4).contiguous().transpose(3, 4), dtc,
                    A_log, Bc, Cc)
    with pytest.raises(ValueError):                    # not float32
        S.ssd_chunk(xc.double(), dtc, A_log, Bc, Cc)


def _mlstm_chunks(case, device, seed=8):
    """Padded, chunked kernel inputs with the kernel tests' distributions:
    q, k, v ~ N(0, 1), li = ig ~ 2 N, lf = log_sigmoid(fg), fg ~ 2 N + 2."""
    b, s, h, p, chunk = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32))
               .to(device) for _ in range(3))
    ig, fg = (torch.from_numpy(rng.standard_normal((b, s, h)) * 2 + mean)
              .float().to(device) for mean in (0.0, 2.0))
    lf = torch.nn.functional.logsigmoid(fg)
    qq = min(chunk, s)
    nc = -(-s // qq)
    pad = nc * qq - s
    pad5 = (0, 0, 0, 0, 0, pad)
    q, k, v = (torch.nn.functional.pad(t, pad5).reshape(b, nc, qq, h, p)
               for t in (q, k, v))
    li = torch.nn.functional.pad(ig, (0, 0, 0, pad), value=-1e30)
    lf = torch.nn.functional.pad(lf, (0, 0, 0, pad))
    return (q, k, v, li.reshape(b, nc, qq, h).contiguous(),
            lf.reshape(b, nc, qq, h).contiguous(), 1 / np.sqrt(p))


def _mlstm_variant(case):
    """The mLSTM kernel the wrapper chooses: wgmma for head dims that are
    multiples of 128 and whole 64-row chunks up to 256, simt otherwise."""
    _, s, _, p, chunk = case
    q = min(chunk, s)
    return "wgmma" if p % 128 == 0 and q % 64 == 0 and q <= 256 else "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("case, variant",
                         _with_simt(MLSTM_CASES, _mlstm_variant))
def test_mlstm_kernel_matches_plain_twin(cuda_device, case, variant):
    """All seven outputs: y_intra, n_intra, m_intra, states, norms,
    chunk_lf, m_state, in every variant; the wrapper chooses the rule's
    variant and counts the launch under it."""
    ins = _mlstm_chunks(case, cuda_device)
    assert M.variant_for(*ins[:5]) == _mlstm_variant(case)
    before = dict(M.LAUNCHES_BY_VARIANT)
    got = M._launch(*ins, variant)
    torch.cuda.synchronize()
    assert M.LAUNCHES_BY_VARIANT[variant] == before[variant] + 1
    want = M.mlstm_chunk_plain(*ins)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(g.isfinite().all())
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   **MLSTM_TOL)


@pytest.mark.cuda
def test_mlstm_scan_on_the_card_matches_the_cpu_path(cuda_device):
    """The whole chunked scan: kernel + recurrence on the card against the
    plain twin + recurrence on the CPU."""
    b, s, h, p = 1, 700, 2, 256
    rng = np.random.default_rng(9)
    arrays = [rng.standard_normal((b, s, h, p), np.float32) for _ in range(3)]
    arrays += [(rng.standard_normal((b, s, h)) * 0.64 + m).astype(np.float32)
               for m in (0.0, 3.0)]
    ins = [torch.from_numpy(a) for a in arrays]
    got = mlstm_scan(*(t.to(cuda_device) for t in ins))
    want = mlstm_scan(*ins)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **MLSTM_TOL)


@pytest.mark.cuda
def test_mlstm_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, li, lf, scale = _mlstm_chunks((1, 64, 2, 16, 32), cuda_device)
    with pytest.raises(ValueError):                    # p = 24
        M.mlstm_chunk(*(torch.zeros(1, 2, 32, 2, 24, device=cuda_device)
                        for _ in range(3)), li, lf, scale)
    with pytest.raises(ValueError):                    # Q = 512
        big = torch.zeros(1, 1, 512, 2, 16, device=cuda_device)
        gate = torch.zeros(1, 1, 512, 2, device=cuda_device)
        M.mlstm_chunk(big, big, big, gate, gate, scale)
    with pytest.raises(ValueError):                    # not contiguous
        M.mlstm_chunk(q.transpose(3, 4).contiguous().transpose(3, 4), k, v,
                      li, lf, scale)
    with pytest.raises(ValueError):                    # not float32
        M.mlstm_chunk(q.double(), k, v, li, lf, scale)


def _swiglu_inputs(case, dtype, device, seed=10):
    """x ~ 0.5 N, wg, wu ~ 0.05 N (tests/test_kernels.py), (E, ...) form."""
    e, m, k, f = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32) * scale)
            .to(device, getattr(torch, dtype))
            for s, scale in (((e, m, k), 0.5), ((e, k, f), 0.05),
                             ((e, k, f), 0.05))]


def _swiglu_variants():
    """(case, variant, dtype) for every kernel the SwiGLU wrapper can
    choose: simt in fp32, mma_sync in bf16 on every case, wgmma in bf16
    where TMA can describe the rows (K, F multiples of 8)."""
    out = []
    for case in SWIGLU_CASES:
        out += [(case, "simt", "float32"), (case, "mma_sync", "bfloat16")]
        if case[2] % 8 == 0 and case[3] % 8 == 0:
            out.append((case, "wgmma", "bfloat16"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case, variant, dtype", _swiglu_variants())
def test_swiglu_kernel_matches_plain_twin(cuda_device, case, variant,
                                          dtype):
    x, wg, wu = _swiglu_inputs(case, dtype, cuda_device)
    if case[0] == 1:                       # the dense (M, K) form
        x, wg, wu = x[0], wg[0], wu[0]
    before = dict(W.LAUNCHES_BY_VARIANT)
    got = W._launch(x, wg, wu, variant)
    torch.cuda.synchronize()
    assert W.LAUNCHES_BY_VARIANT[variant] == before[variant] + 1
    want = W.fused_swiglu_plain(x, wg, wu)
    assert got.shape == want.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **_tol(getattr(torch, dtype)))


@pytest.mark.cuda
def test_swiglu_wrapper_routes_by_its_rule(cuda_device):
    """The wrapper launches the variant choose_variant names: wgmma for
    granite-moe's expert shape and a decode step, mma_sync for an unaligned
    K, simt for fp32."""
    for case, dtype, want in [((32, 2560, 1024, 512), "bfloat16", "wgmma"),
                              ((1, 4, 3072, 8192), "bfloat16", "wgmma"),
                              ((3, 70, 203, 37), "bfloat16", "mma_sync"),
                              ((1, 128, 256, 512), "float32", "simt")]:
        x, wg, wu = _swiglu_inputs(case, dtype, cuda_device)
        before = dict(W.LAUNCHES_BY_VARIANT)
        W.fused_swiglu(x, wg, wu)
        assert W.LAUNCHES_BY_VARIANT[want] == before[want] + 1, case


@pytest.mark.cuda
def test_swiglu_wgmma_and_mma_sync_agree_at_a_path_shape(cuda_device):
    """llama3.2-3b's MLP widths (K 3072, F 8192) at M = 2048: the two bf16
    designs within the bf16 tolerance."""
    x, wg, wu = (t[0] for t in _swiglu_inputs((1, 2048, 3072, 8192),
                                               "bfloat16", cuda_device))
    new = W._launch(x, wg, wu, "wgmma")
    old = W._launch(x, wg, wu, "mma_sync")
    np.testing.assert_allclose(new.float().cpu().numpy(),
                               old.float().cpu().numpy(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_bf16_llama_prefill_runs_only_the_wgmma_kernels(cuda_device):
    """A reduced llama3.2-3b (2 layers at full width) prefill in bf16 at
    S = 1024 > block_q: every flash and SwiGLU launch is a wgmma one."""
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"], n_layers=2,
                              attention_impl="pallas")
    assert cfg.dtype == "bfloat16"
    model = build_model(cfg)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (1, 1024))).to(cuda_device)
    K.reset_launches()
    W.reset_launches()
    with torch.no_grad():
        logits = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert bool(logits.isfinite().all())
    assert K.LAUNCHES_BY_VARIANT == {"wgmma": 2, "simt": 0}
    assert W.LAUNCHES_BY_VARIANT == {"wgmma": 2, "mma_sync": 0, "simt": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_lm_on_the_card_matches_the_cpu_path(cuda_device, dtype):
    """A reduced llama-3.2-vision-11b (2 super-blocks of one self and one
    cross block, head dim 64, GQA 4/2, every xgate 0.5) at S = 300 against
    200 image tokens: the card's forward (4 self- and 2 cross-attention
    flash launches, 4 SwiGLU, all wgmma in bf16, all simt in fp32)
    against the same weights on the CPU, normwise within 1e-4 (fp32) or
    the CPU bf16 model tests' 2e-2."""
    import copy

    from repro_torch.models.model import build_model, reduce_config

    cfg = reduce_config(ARCHS["llama-3.2-vision-11b"], d_model=256,
                        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512,
                        image_tokens=200, attention_impl="pallas",
                        block_q=64, block_kv=64, dtype=dtype)
    model = build_model(cfg)
    params = model.init(0)
    for p in params.cross_blocks:
        p.xgate.data.fill_(0.5)
    rng = np.random.default_rng(15)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 300))),
             "image_embeds": torch.from_numpy(rng.standard_normal(
                 (2, 200, cfg.d_model), np.float32))}
    variant = "wgmma" if dtype == "bfloat16" else "simt"
    K.reset_launches()
    W.reset_launches()
    with torch.no_grad():
        got = model.forward(params, {k: v.to(cuda_device)
                                     for k, v in batch.items()})
    torch.cuda.synchronize()
    assert K.LAUNCHES == K.LAUNCHES_BY_VARIANT[variant] == 6
    assert W.LAUNCHES == W.LAUNCHES_BY_VARIANT[variant] == 4
    with torch.no_grad():
        want = model.forward(copy.deepcopy(params).to("cpu"), batch).float()
    got = got.float().cpu()
    assert bool(got.isfinite().all())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= (2e-2 if dtype == "bfloat16" else 1e-4), rel


@pytest.mark.cuda
def test_swiglu_kernel_rejects_what_it_does_not_take(cuda_device):
    x, wg, wu = _swiglu_inputs((1, 64, 64, 64), "float32", cuda_device)
    with pytest.raises(ValueError):                    # float64
        W.fused_swiglu(x.double(), wg.double(), wu.double())
    with pytest.raises(ValueError):                    # mixed dtypes
        W.fused_swiglu(x.bfloat16(), wg, wu)
    with pytest.raises(ValueError):                    # not contiguous
        W.fused_swiglu(x, wg.transpose(1, 2), wu.transpose(1, 2))
    with pytest.raises(ValueError):                    # two devices
        W.fused_swiglu(x, wg.cpu(), wu)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_layer_on_the_card_matches_the_cpu_path(cuda_device, impl):
    """granite-moe-1b-a400m's MoE layer at full width (d 1024, 32 experts
    top-8 of width 512), fp32, 2 groups of 300 tokens: the kernel path on
    the card against the plain path on the CPU, same parameters."""
    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"], dtype="float32",
                              moe_impl=impl)
    params = moe.moe_init(torch.Generator("cpu").manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 300, cfg.d_model), np.float32))
    want, want_aux = moe.moe_forward(cfg, params, x)
    before = W.LAUNCHES
    got, aux = moe.moe_forward(
        cfg, {n: p.to(cuda_device) for n, p in params.items()},
        x.to(cuda_device))
    torch.cuda.synchronize()
    assert W.LAUNCHES == before + 1          # every expert in one launch
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.cuda
def test_ssd_and_mlstm_wrappers_route_by_their_rules(cuda_device):
    """The public wrappers launch the variant choose_variant names: wgmma
    at the zamba2-7b and xlstm-1.3b chunk shapes, simt for widths 32 and
    head dim 64."""
    for case, want in [((1, 300, 8, 64, 64, 256), "wgmma"),
                       ((2, 128, 4, 32, 64, 64), "simt")]:
        x, dt, A_log, B, C = _ssd_inputs(case, cuda_device)
        chunks = chunk_inputs(x, dt, B, C, case[-1])
        before = dict(S.LAUNCHES_BY_VARIANT)
        S.ssd_chunk(chunks[0], chunks[1], A_log, *chunks[2:])
        assert S.LAUNCHES_BY_VARIANT[want] == before[want] + 1, case
    for case, want in [((1, 300, 2, 256, 256), "wgmma"),
                       ((1, 300, 2, 64, 256), "simt")]:
        before = dict(M.LAUNCHES_BY_VARIANT)
        M.mlstm_chunk(*_mlstm_chunks(case, cuda_device))
        assert M.LAUNCHES_BY_VARIANT[want] == before[want] + 1, case


def _needs_grad(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.cuda
def test_swiglu_refuses_a_gradient_on_the_card(cuda_device):
    """The kernel used to refuse a gradient; it now has a backward (the
    plain twin's autograd): under grad its output carries a grad_fn whose
    grads equal the twin's, the forward launched once; under no_grad it
    runs too."""
    x, wg, wu = _swiglu_inputs((1, 64, 64, 64), "float32", cuda_device)
    ins = [_needs_grad(t[0]) for t in (x, wg, wu)]
    before = W.LAUNCHES
    h = W.fused_swiglu(*ins)
    assert h.grad_fn is not None and W.LAUNCHES == before + 1
    dh = torch.randn_like(h)
    got = torch.autograd.grad(h, ins, dh)
    twins = [_needs_grad(t[0]) for t in (x, wg, wu)]
    want = torch.autograd.grad(W.fused_swiglu_plain(*twins), twins, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        W.fused_swiglu(_needs_grad(x[0]), wg[0], wu[0])


@pytest.mark.cuda
def test_ssd_refuses_a_gradient_on_the_card(cuda_device):
    """The chunk kernel's wrapper still refuses a gradient (nothing may
    drop one by going around the scan); the scan carries one through its
    Function: the kernel forward, ``ssd_chunked``'s vjp backward."""
    x, dt, A_log, B, C = _ssd_inputs((1, 64, 2, 64, 64, 64), cuda_device)
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, 64)
    with pytest.raises(NotImplementedError):
        S.ssd_chunk(_needs_grad(xc), dtc, A_log, Bc, Cc)
    with torch.no_grad():
        S.ssd_chunk(_needs_grad(xc), dtc, A_log, Bc, Cc)
    before = S.LAUNCHES
    leaf = _needs_grad(A_log)
    y = ssd_scan(x, dt, leaf, B, C)
    assert y.grad_fn is not None and S.LAUNCHES == before + 1
    y.sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())


@pytest.mark.cuda
def test_mlstm_refuses_a_gradient_on_the_card(cuda_device):
    """As for SSD: ``mlstm_chunk`` refuses a gradient, ``mlstm_scan``
    carries one."""
    q, k, v, li, lf, scale = _mlstm_chunks((1, 64, 2, 128, 64), cuda_device)
    with pytest.raises(NotImplementedError):
        M.mlstm_chunk(q, _needs_grad(k), v, li, lf, scale)
    with torch.no_grad():
        M.mlstm_chunk(q, _needs_grad(k), v, li, lf, scale)
    g = torch.Generator(cuda_device).manual_seed(5)
    qs, ks, vs = (torch.randn(1, 64, 2, 128, generator=g, device=cuda_device)
                  for _ in range(3))
    ig, fg = (torch.randn(1, 64, 2, generator=g, device=cuda_device)
              for _ in range(2))
    before = M.LAUNCHES
    leaf = _needs_grad(ks)
    y = mlstm_scan(qs, leaf, vs, ig, fg)
    assert y.grad_fn is not None and M.LAUNCHES == before + 1
    y.sum().backward()
    assert leaf.grad is not None and bool(torch.isfinite(leaf.grad).all())


# depth of each model at full width for the bf16 check (chip_smoke.py's
# phase_bf16_parity): one group of zamba2-7b.  xlstm-1.3b is held per
# mLSTM block (test_bf16_xlstm_block_parity_on_the_card): at depth 8 its
# logits move by ~0.1 between two correct fp32 mLSTM implementations.
BF16_DEPTHS = {"llama3.2-3b": 2, "zamba2-7b": 7, "granite-moe-1b-a400m": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(BF16_DEPTHS))
def test_bf16_model_parity_on_the_card(cuda_device, arch):
    """The card path in bf16 (every flash, SwiGLU, SSD and mLSTM launch a
    wgmma one) against the plain path, the same weights on the CPU, at
    S = 640, normwise within the CPU bf16 model tests' 2e-2.  granite-moe's
    CPU path replays the card's expert choices (a flipped near-tie would
    move a token's logits by O(1)); the flips are counted in chip_smoke."""
    import copy

    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas",
                              dtype="bfloat16", n_layers=BF16_DEPTHS[arch])
    model = build_model(cfg)
    params = model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab, (1, 640))).to(cuda_device)
    card_masks, cpu_masks = [], []
    top_k_mask = moe._top_k_mask
    replay = []              # set once the card path has run

    def recorded(probs, k):
        mask, weights = top_k_mask(probs, k)
        if not replay:
            card_masks.append(mask.cpu())
            return mask, weights
        card = card_masks[len(cpu_masks)].to(mask.dtype)
        cpu_masks.append(mask)
        w = probs * card
        return card, w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

    moe._top_k_mask = recorded
    try:
        for m in (K, W, S, M):
            m.reset_launches()
        with torch.no_grad():
            got = model.forward(params, {"tokens": tokens}).float().cpu()
        for m in (K, W, S, M):
            assert m.LAUNCHES == m.LAUNCHES_BY_VARIANT["wgmma"], m.__name__
        assert K.LAUNCHES + S.LAUNCHES + M.LAUNCHES > 0
        replay.append(True)
        with torch.no_grad():
            want = model.forward(copy.deepcopy(params).to("cpu"),
                                 {"tokens": tokens.cpu()}).float()
    finally:
        moe._top_k_mask = top_k_mask
    assert bool(got.isfinite().all())
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 2e-2, rel


@pytest.mark.cuda
def test_bf16_xlstm_block_parity_on_the_card(cuda_device):
    """One mLSTM block of xlstm-1.3b at full width in bf16, S = 640 (three
    chunks, the last ragged): the card path (the wgmma kernel) against the
    plain path on the CPU, normwise within the CPU bf16 tests' 2e-2."""
    import copy

    from repro_torch.models import xlstm
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS["xlstm-1.3b"], n_layers=8)
    assert cfg.dtype == "bfloat16"
    params = build_model(cfg).init(0)
    block = params.mblocks[0]
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (1, 640, cfg.d_model), np.float32)).to(cuda_device, torch.bfloat16)
    M.reset_launches()
    with torch.no_grad():
        got = xlstm.mlstm_forward(cfg, block.mlstm, x).float().cpu()
        assert M.LAUNCHES_BY_VARIANT == {"wgmma": 1, "simt": 0}
        want = xlstm.mlstm_forward(cfg, copy.deepcopy(block).to("cpu").mlstm,
                                   x.cpu()).float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= 2e-2, rel
