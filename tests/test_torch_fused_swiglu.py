"""Port parity: the fused SwiGLU kernel's plain twin, its model-facing
wrapper and its oracle against the JAX package (the Pallas kernel in
interpret mode and ``swiglu_ref``).

The CUDA kernel itself runs only on a card; its cases are in
``test_torch_cuda_kernels.py``, which needs no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_swiglu.kernel import \
    fused_swiglu_pallas as jax_fused_swiglu  # noqa: E402
from repro.kernels.fused_swiglu.ref import \
    swiglu_ref as jax_swiglu_ref  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as K  # noqa: E402
from repro_torch.kernels.fused_swiglu import ops  # noqa: E402
from repro_torch.kernels.fused_swiglu.ref import swiglu_ref  # noqa: E402

torch.set_num_threads(1)

SWIGLU_CASES = [
    # (m, k, f, bm, bf, bk): tests/test_kernels.py:175
    (128, 256, 512, 64, 128, 128),
    (256, 512, 256, 128, 256, 256),
    (100, 200, 300, 64, 128, 128),   # ragged everywhere
    (64, 64, 64, 64, 64, 64),        # single tile
]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # tests/test_kernels.py:_tol
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(shape_x, shape_w, seed=0):
    """x ~ 0.5 N, wg, wu ~ 0.05 N (tests/test_kernels.py), float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_x, np.float32) * 0.5,
            rng.standard_normal(shape_w, np.float32) * 0.05,
            rng.standard_normal(shape_w, np.float32) * 0.05)


def _pair(arrays, dtype):
    """The same arrays as torch and jnp tensors of ``dtype`` (both round
    float32 to bf16 to nearest even)."""
    return ([torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays],
            [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", SWIGLU_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_twin_matches_jax_kernel_and_ref(case, dtype):
    m, k, f, bm, bf, bk = case
    (x, wg, wu), (jx, jwg, jwu) = _pair(_inputs((m, k), (k, f)), dtype)
    want_kernel = jax_fused_swiglu(jx, jwg, jwu, block_m=bm, block_f=bf,
                                   block_k=bk, interpret=True)
    want_ref = jax_swiglu_ref(jx, jwg, jwu)
    before = K.LAUNCHES
    got = K.fused_swiglu(x, wg, wu)
    assert K.LAUNCHES == before          # CPU tensors never reach the kernel
    assert got.shape == (m, f) and got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(want_kernel), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_np(swiglu_ref(x, wg, wu)), _np(want_ref),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_expert_form_matches_a_loop_over_experts(dtype):
    """(E, M, K) x (E, K, F): one call for all experts, as a MoE layer
    makes it, equals one call per expert."""
    e, m, k, f = 4, 48, 64, 40
    (x, wg, wu), _ = _pair(_inputs((e, m, k), (e, k, f), seed=1), dtype)
    got = K.fused_swiglu(x, wg, wu)
    assert got.shape == (e, m, f) and got.dtype == x.dtype
    for i in range(e):
        np.testing.assert_allclose(_np(got[i]),
                                   _np(K.fused_swiglu(x[i], wg[i], wu[i])),
                                   **_tol(dtype))
    np.testing.assert_allclose(_np(ops.fused_swiglu(x, wg, wu)), _np(got),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ops_folds_leading_dims(dtype):
    """A dense MLP's (B, S, K) input is one (B·S, K) call, unfolded after,
    against the JAX kernel on the folded rows."""
    b, s, k, f = 2, 37, 64, 96
    (x, wg, wu), (jx, jwg, jwu) = _pair(_inputs((b, s, k), (k, f), seed=2),
                                        dtype)
    got = ops.fused_swiglu(x, wg, wu)
    assert got.shape == (b, s, f)
    want = jax_fused_swiglu(jx.reshape(b * s, k), jwg, jwu, block_m=64,
                            block_f=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_np(got).reshape(b * s, f), _np(want),
                               **_tol(dtype))
    # a non-contiguous input is made contiguous by the wrapper
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    np.testing.assert_allclose(_np(ops.fused_swiglu(xt, wg, wu)), _np(got),
                               rtol=0, atol=0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, wg, wu = (torch.from_numpy(a)
                 for a in _inputs((8, 16), (16, 24), seed=3))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        K.fused_swiglu(x.double(), wg.double(), wu.double())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        K.fused_swiglu(x.bfloat16(), wg, wu)
    with pytest.raises(ValueError, match="does not match"):
        K.fused_swiglu(x[:, :8], wg, wu)
    with pytest.raises(ValueError, match="wu"):
        K.fused_swiglu(x, wg, wu[:, :8])
    with pytest.raises(ValueError, match=r"\(E, M, K\)"):
        K.fused_swiglu(x[None, None], wg[None, None], wu[None, None])
    with pytest.raises(ValueError, match="does not match"):
        K.fused_swiglu(x[None].expand(2, 8, 16).contiguous(),
                       wg[None].expand(3, 16, 24).contiguous(),
                       wu[None].expand(3, 16, 24).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_swiglu(x, wg.T.contiguous().T, wu)
    with pytest.raises(ValueError, match="one device"):
        K.fused_swiglu(x, wg.to("meta"), wu)
    with pytest.raises(ValueError, match="unsupported device"):
        K.fused_swiglu(x.to("meta"), wg.to("meta"), wu.to("meta"))


# ---- the routing rule and the wgmma kernel's launch plan (no card) ----

PATH_SHAPES = {
    # (e, m, k, f) at the prefill steps (B = 2, S = 4096)
    "llama3.2-3b MLP": (1, 8192, 3072, 8192),
    "zamba2-7b shared MLP": (1, 8192, 3584, 14336),
    "granite-moe-1b-a400m experts": (32, 2560, 1024, 512),
}


@pytest.mark.parametrize("path", PATH_SHAPES)
def test_path_shapes_take_the_wgmma_kernel_in_bf16(path):
    shape = PATH_SHAPES[path]
    assert K.choose_variant("cuda", torch.bfloat16, shape, False) == "wgmma"
    assert K.choose_variant("cuda", torch.float32, shape, False) == "simt"
    assert K.choose_variant("cpu", torch.bfloat16, shape, False) == "plain"


@pytest.mark.parametrize("shape, why", [
    ((3, 1000, 1003, 700), "K not a multiple of 8"),
    ((1, 1000, 1024, 702), "F not a multiple of 8"),
    ((1, 1000, 0, 512), "K = 0"),
])
def test_shapes_tma_or_the_tiles_do_not_suit_take_mma_sync(shape, why):
    assert K.choose_variant("cuda", torch.bfloat16, shape, False) \
        == "mma_sync", why


def test_misaligned_bases_take_mma_sync():
    shape = PATH_SHAPES["llama3.2-3b MLP"]
    assert K.choose_variant("cuda", torch.bfloat16, shape, True) \
        == "mma_sync"
    assert K.choose_variant("cuda", torch.float32, shape, True) == "simt"


@pytest.mark.parametrize("shape", [(1, 4, 3072, 8192), (32, 4, 1024, 512),
                                   (1, 1, 64, 64)])
def test_decode_rows_take_the_wgmma_kernel(shape):
    """M does not enter the rule: a decode step's few rows run the wgmma
    kernel, measured no slower there than the mma_sync one."""
    assert K.choose_variant("cuda", torch.bfloat16, shape, False) == "wgmma"


def test_variant_for_reads_the_dense_and_expert_forms():
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    assert K.variant_for(meta(8192, 3072), meta(3072, 8192),
                         meta(3072, 8192)) == "wgmma"
    assert K.variant_for(meta(32, 2560, 1024), meta(32, 1024, 512),
                         meta(32, 1024, 512)) == "wgmma"
    assert K.variant_for(meta(4, 3072), meta(3072, 8192),
                         meta(3072, 8192)) == "wgmma"
    assert K.variant_for(meta(4, 3070), meta(3070, 8192),
                         meta(3070, 8192)) == "mma_sync"


def test_wgmma_shared_memory_fits_a_block():
    """fused_swiglu_wgmma.cu's SMEM_ALLOC: four stages of x (128 x 64) and
    Wg, Wu (64 x 128) tiles, barriers and the alignment slack."""
    got = K.wgmma_smem_bytes()
    assert got == 4 * (128 * 64 + 2 * 64 * 128) * 2 + 8 * 8 + 1024
    assert got <= K.SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_never_reach_a_cuda_variant(dtype):
    x, wg, wu = (torch.from_numpy(a).to(getattr(torch, dtype))
                 for a in _inputs((8192 // 64, 3072 // 16), (192, 512)))
    assert K.variant_for(x, wg, wu) == "plain"
    before = dict(K.LAUNCHES_BY_VARIANT)
    K.fused_swiglu(x, wg, wu)
    assert K.LAUNCHES_BY_VARIANT == before


def test_reset_launches_zeroes_every_count():
    K.LAUNCHES = 5
    K.LAUNCHES_BY_VARIANT["wgmma"] = 5
    K.reset_launches()
    assert K.LAUNCHES == 0
    assert K.LAUNCHES_BY_VARIANT == dict.fromkeys(K.VARIANTS, 0)


def test_cpu_twin_differentiates():
    """On the CPU the wrapper runs the twin, plain torch ops, so a gradient
    flows (on the card the wrapper refuses one: test_torch_cuda_kernels)."""
    x, wg, wu = (torch.from_numpy(a).requires_grad_(True)
                 for a in _inputs((16, 32), (32, 24)))
    K.fused_swiglu(x, wg, wu).sum().backward()
    for t in (x, wg, wu):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
