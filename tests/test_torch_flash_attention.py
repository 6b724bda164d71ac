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
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == (1, 8, 2, 32)


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
