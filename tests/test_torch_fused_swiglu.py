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
