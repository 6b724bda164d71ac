"""Port parity: the mLSTM chunk kernel's plain twin, the chunked scan around
it and the sequential oracle against the JAX package (Pallas kernel in
interpret mode, the Pallas scan, the jnp ``mlstm_chunked`` of
``models/xlstm.py`` and ``mlstm_ref``).

The CUDA kernel itself runs only on a card; its cases are in
``test_torch_cuda_kernels.py``, which needs no JAX.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm_scan.kernel import \
    mlstm_chunk_pallas as jax_mlstm_chunk  # noqa: E402
from repro.kernels.mlstm_scan.ops import \
    mlstm_scan as jax_mlstm_scan  # noqa: E402
from repro.kernels.mlstm_scan.ref import \
    mlstm_ref as jax_mlstm_ref  # noqa: E402
from repro.models.xlstm import mlstm_chunked as jax_mlstm_chunked  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as K  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan  # noqa: E402
from repro_torch.kernels.mlstm_scan.ref import mlstm_ref  # noqa: E402

torch.set_num_threads(1)

# (b, s, h, p, chunk, gates): tests/test_kernels.py:130 with its gate
# distributions (ig ~ 2 N, fg ~ 2 N + 2), then one chunk-256 case at a
# ragged S = 600 with xlstm-1.3b's gate distribution (w_if ~ 0.01 N over
# di = 4096 inputs: std 0.64, forget bias +3)
TEST_GATES = (2.0, 0.0, 2.0, 2.0)        # ig std, ig mean, fg std, fg mean
MODEL_GATES = (0.64, 0.0, 0.64, 3.0)
MLSTM_CASES = [
    (1, 64, 2, 16, 32, TEST_GATES),
    (2, 128, 4, 32, 64, TEST_GATES),
    (1, 100, 2, 16, 32, TEST_GATES),      # ragged
    (1, 32, 1, 64, 32, TEST_GATES),       # single chunk
    (1, 600, 2, 32, 256, MODEL_GATES),    # xlstm-like, ragged, 3 chunks
]
TOL = dict(rtol=1e-4, atol=1e-4)          # tests/test_kernels.py:151


def _inputs(case, seed=0):
    """q, k, v ~ N(0, 1), then the input and forget gate logits, as
    float32 numpy arrays."""
    b, s, h, p, _, (ig_std, ig_mean, fg_std, fg_mean) = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, p), np.float32)
               for _ in range(3))
    ig = (rng.standard_normal((b, s, h)) * ig_std + ig_mean) \
        .astype(np.float32)
    fg = (rng.standard_normal((b, s, h)) * fg_std + fg_mean) \
        .astype(np.float32)
    return q, k, v, ig, fg


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _chunks(case, arrays):
    """The padded, chunked kernel inputs ops.py builds: q, k, v
    (b, nc, Q, h, p), li (padded with -1e30) and lf = log_sigmoid(fg)."""
    b, s, h, p, chunk, _ = case
    q, k, v, ig, fg = arrays
    qq = min(chunk, s)
    nc = -(-s // qq)
    pad = nc * qq - s
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(fg)), np.float32)

    def padded(a, value=0.0):
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        out = np.pad(a, widths, constant_values=value)
        return np.ascontiguousarray(out.reshape((b, nc, qq) + a.shape[2:]))

    return (padded(q), padded(k), padded(v), padded(ig, -1e30), padded(lf))


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_plain_twin_matches_jax_kernel(case):
    """All seven outputs of the intra-chunk kernel on the padded chunks:
    y_intra, n_intra, m_intra, states, norms, chunk_lf, m_state."""
    chunks = _chunks(case, _inputs(case))
    scale = 1.0 / math.sqrt(case[3])
    want = jax_mlstm_chunk(*(jnp.asarray(a) for a in chunks),
                           sm_scale=scale, interpret=True)
    before = K.LAUNCHES
    got = K.mlstm_chunk(*_torch(chunks), scale)
    assert K.LAUNCHES == before       # CPU tensors never reach the kernel
    b, nc, qq, h, p = chunks[0].shape
    assert [tuple(g.shape) for g in got] == [
        (b, nc, qq, h, p), (b, nc, qq, h), (b, nc, qq, h), (b, nc, h, p, p),
        (b, nc, h, p), (b, nc, h), (b, nc, h)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and bool(g.isfinite().all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_scan_matches_jax_scan_and_models_mlstm_chunked(case):
    """The port's chunked scan against the reference's Pallas scan
    (interpret mode) and the jnp ``mlstm_chunked`` that ``models/xlstm.py``
    calls: the same function, elementwise at the kernel tests' tolerance."""
    arrays = _inputs(case, 1)
    chunk = case[4]
    got = mlstm_scan(*_torch(arrays), chunk=chunk)
    assert got.shape == case[:4] and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_mlstm_scan(*j, chunk=chunk,
                                               interpret=True)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_mlstm_chunked(*j, chunk=chunk)), **TOL)


@pytest.mark.parametrize("case", MLSTM_CASES)
def test_mlstm_scan_and_ref_match_jax_ref(case):
    """Against the exact stabilised sequential recurrence, at the kernel
    tests' tolerance, as ``tests/test_kernels.py`` holds the reference's
    scan."""
    arrays = _inputs(case, 2)
    want = np.asarray(jax_mlstm_ref(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(mlstm_ref(*_torch(arrays)).numpy(), want,
                               **TOL)
    got = mlstm_scan(*_torch(arrays), chunk=case[4]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_padded_rows_are_weightless():
    """A ragged S is padded with li = -1e30; the first S rows equal those
    of the same scan on the longer, unpadded sequence."""
    case = (1, 96, 2, 16, 32, TEST_GATES)
    full_in = _torch(_inputs(case, 3))
    full = mlstm_scan(*full_in, chunk=32)
    part = mlstm_scan(*(t[:, :70] for t in full_in), chunk=32)
    np.testing.assert_allclose(part.numpy(), full[:, :70].numpy(), **TOL)


@pytest.mark.parametrize("bad", ["k", "v", "li", "lf", "q"])
def test_wrapper_rejects_bad_shapes(bad):
    shapes = {"q": (1, 2, 8, 2, 16), "k": (1, 2, 8, 2, 16),
              "v": (1, 2, 8, 2, 16), "li": (1, 2, 8, 2), "lf": (1, 2, 8, 2)}
    shapes[bad] = {"q": (1, 2, 8, 2), "k": (1, 2, 8, 2, 32),
                   "v": (1, 2, 7, 2, 16), "li": (1, 2, 8, 3),
                   "lf": (1, 2, 8)}[bad]
    args = [torch.zeros(shapes[n]) for n in ("q", "k", "v", "li", "lf")]
    with pytest.raises(ValueError):
        K.mlstm_chunk(*args, 0.25)


def test_choose_variant_routes_by_head_dim_and_chunk():
    """wgmma for p a multiple of 128 and whole 64-row tiles up to Q = 256
    (xlstm-1.3b's p = 1024); simt for the other head dims, ragged chunks
    and offset views; the twin for CPU tensors."""
    cv = K.choose_variant
    assert cv("cpu", (256, 1024), False) == "plain"
    for shape in [(256, 1024), (64, 128), (192, 512)]:
        assert cv("cuda", shape, False) == "wgmma", shape
    for shape in [(256, 64), (256, 16), (256, 1000), (32, 1024),
                  (100, 1024), (600, 1024)]:
        assert cv("cuda", shape, False) == "simt", shape
    assert cv("cuda", (256, 1024), True) == "simt"


def test_cpu_twin_differentiates():
    """On the CPU the wrapper runs the twin, plain torch ops, so a gradient
    flows (on the card the wrapper refuses one: test_torch_cuda_kernels)."""
    q, k, v, ig, fg = _torch(_inputs((1, 64, 2, 16, 32, TEST_GATES), 6))
    for t in (q, k, v):
        t.requires_grad_(True)
    y = mlstm_scan(q, k, v, ig, fg, chunk=32)
    y.sum().backward()
    for t in (q, k, v):
        assert t.grad is not None and bool(t.grad.isfinite().all())
        assert bool(t.grad.abs().sum() > 0)
