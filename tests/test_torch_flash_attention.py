"""Port parity: the flash-attention kernel's plain twin, (B,S,H,D) wrapper
and oracle against the JAX package (Pallas kernel in interpret mode).

The CUDA kernel itself runs only on a card; its cases are in
``test_torch_cuda_kernels.py``, which needs no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash_fwd  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402

torch.set_num_threads(1)

# the cases of tests/test_kernels.py, plus the zamba2-7b head dim
FLASH_CASES = [
    # (b, hq, hkv, sq, skv, d, causal, block_q, block_kv)
    (1, 2, 2, 128, 128, 64, True, 64, 64),
    (2, 4, 2, 256, 256, 64, True, 128, 128),     # GQA 2:1
    (1, 8, 1, 128, 128, 128, True, 64, 64),      # MQA
    (1, 2, 2, 200, 200, 64, True, 64, 64),       # ragged seq (padding)
    (1, 2, 2, 128, 256, 64, False, 64, 128),     # cross attention
    (2, 2, 2, 256, 256, 32, True, 256, 256),     # single block
    (1, 2, 2, 200, 200, 112, True, 64, 64),      # zamba2-7b head dim
]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _tol(tdtype):
    # tests/test_kernels.py:_tol
    return dict(rtol=2e-2, atol=2e-2) if tdtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32),
            rng.standard_normal((b, hkv, skv, d), np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_plain_twin_matches_jax_kernel(case, dtypes):
    b, hq, hkv, sq, skv, d, causal, bq, bkv = case
    jdt, tdt = dtypes
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, sq, skv, d),
                                       jdt, tdt)
    want = jax.jit(lambda q, k, v: jax_flash_fwd(
        q, k, v, causal=causal, block_q=bq, block_kv=bkv,
        interpret=True))(jq, jk, jv)
    before = K.LAUNCHES
    got = K.flash_attention_fwd(tq, tk, tv, causal=causal, block_q=bq,
                                block_kv=bkv)
    assert K.LAUNCHES == before       # CPU tensors never reach the kernel
    assert got.dtype == tdt and got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(tdt))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_ref_matches_jax_ref(case):
    b, hq, hkv, sq, skv, d, causal, _, _ = case
    jdt, tdt = DTYPES[0]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, sq, skv, d, 1),
                                       jdt, tdt)
    want = jax.jit(lambda q, k, v: jax_attention_ref(
        q, k, v, causal=causal))(jq, jk, jv)
    got = attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(tdt))


@pytest.mark.parametrize("case", [FLASH_CASES[1], FLASH_CASES[3],
                                  FLASH_CASES[4]])
def test_ops_bshd_api_matches_jax_ops(case):
    b, hq, hkv, sq, skv, d, causal, bq, bkv = case
    arrays = [a.transpose(0, 2, 1, 3)
              for a in _inputs(b, hq, hkv, sq, skv, d, 2)]
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, jnp.float32, torch.float32)
    want = jax.jit(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, block_q=bq, block_kv=bkv))(jq, jk, jv)
    got = flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                          block_kv=bkv)
    assert got.shape == (b, sq, hq, d)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(torch.float32))


def test_causal_mask_is_top_left_when_sq_ne_skv():
    """Sq != Skv: the kernel (and the port) keep q_pos >= k_pos from the
    top-left corner; the oracle aligns bottom-right and differs."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 2, 2, 128, 256, 64, 3),
                                       jnp.float32, torch.float32)
    want = jax.jit(lambda q, k, v: jax_flash_fwd(
        q, k, v, causal=True, block_q=64, block_kv=128,
        interpret=True))(jq, jk, jv)
    got = K.flash_attention_fwd(tq, tk, tv, causal=True, block_q=64,
                                block_kv=128)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(torch.float32))
    bottom_right = attention_ref(tq, tk, tv, causal=True)
    assert not np.allclose(_np(got), _np(bottom_right), atol=1e-2)


def test_ops_is_forward_only():
    """The wrapper used to refuse a gradient; it now carries one (the
    reference's recompute backward, held to ``jax.vjp`` in
    ``tests/test_torch_train.py``): under grad its output has a grad_fn
    and backward fills q's grad; under no_grad it has none."""
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    k = torch.zeros(1, 8, 2, 32)
    out = flash_attention(q, k, k)
    assert out.shape == (1, 8, 2, 32) and out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    with torch.no_grad():
        out = flash_attention(q, k, k)
    assert out.shape == (1, 8, 2, 32) and out.grad_fn is None


@pytest.mark.parametrize("shapes", [
    ((1, 3, 8, 32), (1, 2, 8, 32)),      # heads not a multiple
    ((1, 2, 8, 32), (1, 2, 8, 64)),      # head dims differ
    ((1, 2, 8, 32), (1, 2, 0, 32)),      # no keys
])
def test_wrapper_rejects_bad_shapes(shapes):
    qs, ks = shapes
    with pytest.raises(ValueError):
        K.flash_attention_fwd(torch.zeros(qs), torch.zeros(ks),
                              torch.zeros(ks))


# ---- the routing rule and the wgmma kernel's launch plan (no card) ----

def _bshd_views(b, s, hq, hkv, d, dtype, device="meta"):
    """(B, S, H, D) tensors as the (B, H, S, D) views ops.py passes."""
    q = torch.empty((b, s, hq, d), dtype=dtype, device=device)
    k = torch.empty((b, s, hkv, d), dtype=dtype, device=device)
    return q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2)


@pytest.mark.parametrize("d", K.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
def test_choose_variant_by_dtype_head_dim_and_alignment(d, dtype, aligned):
    strides = [4096 * 8 * d, d, 8 * d]          # (B, S, H, D) batch, head, seq
    if not aligned:
        strides[2] += 1                          # a row off 16 bytes
    got = K.choose_variant("cuda", dtype, d, strides, misaligned=False)
    want = "wgmma" if dtype == torch.bfloat16 and aligned else "simt"
    assert got == want
    assert K.choose_variant("cuda", dtype, d, strides[:2] + [8 * d],
                            misaligned=True) == "simt"
    assert K.choose_variant("cpu", dtype, d, strides,
                            misaligned=False) == "plain"


def test_choose_variant_refuses_head_dims_the_kernels_lack():
    assert K.choose_variant("cuda", torch.bfloat16, 96, [96], False) \
        == "simt"


@pytest.mark.parametrize("arch, shape", [
    ("llama3.2-3b", (2, 4096, 24, 8, 128)),
    ("zamba2-7b", (2, 4096, 32, 32, 112)),
    ("granite-moe-1b-a400m", (2, 4096, 16, 8, 64)),
    ("ragged", (2, 1000, 24, 8, 128)),
    ("one sequence", (1, 640, 32, 32, 112)),
])
def test_path_shapes_take_the_wgmma_kernel_in_bf16(arch, shape):
    b, s, hq, hkv, d = shape
    assert K.variant_for(*_bshd_views(b, s, hq, hkv, d, torch.bfloat16)) \
        == "wgmma", arch
    assert K.variant_for(*_bshd_views(b, s, hq, hkv, d, torch.float32)) \
        == "simt", arch


def test_size_one_dims_do_not_decide_the_variant():
    """A dim of size 1 never moves the address, so an odd stride there is
    ignored by the rule and replaced for the tensor map."""
    q = torch.empty((1, 4, 128, 64), dtype=torch.bfloat16, device="meta")
    q1 = q.as_strided(q.shape, (3, 128 * 64, 64, 1))
    assert K.variant_for(q1, q, q) == "wgmma"
    assert K._tma_strides(q1)[0] % 8 == 0
    assert K._tma_strides(q1)[1:] == [128 * 64, 64]


@pytest.mark.parametrize("d", K.HEAD_DIMS)
def test_wgmma_shared_memory_fits_a_block(d):
    """flash_fwd_wgmma.cu's Layout<DP>: Q, three K/V stages, barriers and the
    alignment slack fit in the 232,448 bytes a block may use."""
    got = K.wgmma_smem_bytes(d)
    assert got <= K.SMEM_LIMIT
    dp = K.padded_head_dim(d)
    bn = K.wgmma_block_n(d)
    assert dp % 64 == 0 and dp >= d and bn % 16 == 0
    assert (bn * dp * 2) % 1024 == 0          # swizzle atoms stay aligned
    assert got == 128 * dp * 2 + 3 * 2 * bn * dp * 2 + 10 * 8 + 1024


def test_cpu_tensors_never_reach_a_cuda_variant():
    (tq, tk, tv) = [torch.from_numpy(a).bfloat16()
                    for a in _inputs(1, 2, 2, 64, 64, 64)]
    assert K.variant_for(tq, tk, tv) == "plain"
    before = dict(K.LAUNCHES_BY_VARIANT)
    K.flash_attention_fwd(tq, tk, tv)
    assert K.LAUNCHES_BY_VARIANT == before
    with pytest.raises(ValueError, match="unsupported device"):
        K.flash_attention_fwd(*_bshd_views(1, 64, 2, 2, 64,
                                           torch.bfloat16))


def test_reset_launches_zeroes_every_count():
    K.LAUNCHES = 3
    K.LAUNCHES_BY_VARIANT["simt"] = 2
    K.reset_launches()
    assert K.LAUNCHES == 0
    assert K.LAUNCHES_BY_VARIANT == dict.fromkeys(K.VARIANTS, 0)
