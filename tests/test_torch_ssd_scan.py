"""Port parity: the SSD chunk kernel's plain twin, the chunked scan around
it and the sequential oracle against the JAX package (Pallas kernel in
interpret mode, the jnp ``ssd_chunked`` of ``models/ssm.py`` and
``ssd_ref``).

The CUDA kernel itself runs only on a card; its cases are in
``test_torch_cuda_kernels.py``, which needs no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.kernel import \
    ssd_chunk_pallas as jax_ssd_chunk  # noqa: E402
from repro.kernels.ssm_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssm_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as K  # noqa: E402
from repro_torch.kernels.ssm_scan.ops import (chunk_inputs,  # noqa: E402
                                              ssd_scan)
from repro_torch.kernels.ssm_scan.ref import ssd_ref  # noqa: E402

torch.set_num_threads(1)

SSD_CASES = [
    # (b, s, h, p, n, chunk): tests/test_kernels.py, then a zamba2-like
    # mamba layer (p = n = 64, chunk 256) at a ragged S with two chunks
    (1, 64, 2, 16, 16, 32),
    (2, 128, 4, 32, 64, 64),
    (1, 100, 2, 16, 16, 32),      # ragged
    (1, 32, 1, 64, 32, 32),       # single chunk
    (1, 300, 2, 64, 64, 256),     # zamba2-like, ragged
]
TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py:105


def _inputs(case, seed=0):
    """x, dt, A_log, B, C as float32 numpy arrays, with the distributions
    of tests/test_kernels.py (dt = softplus of a normal)."""
    b, s, h, p, n, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p), np.float32),
            np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32),
            (rng.standard_normal(h) * 0.5).astype(np.float32),
            rng.standard_normal((b, s, n), np.float32),
            rng.standard_normal((b, s, n), np.float32))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_twin_matches_jax_kernel(case):
    """All three outputs of the intra-chunk kernel: y_diag, states and
    chunk_lf, on the padded chunks ops.py hands it."""
    x, dt, A_log, B, C = _torch(_inputs(case))
    chunks = chunk_inputs(x, dt, B, C, case[-1])
    xc, dtc, Bc, Cc = chunks
    want = jax_ssd_chunk(*(jnp.asarray(t.numpy()) for t in (xc, dtc)),
                         jnp.asarray(A_log.numpy()),
                         *(jnp.asarray(t.numpy()) for t in (Bc, Cc)),
                         interpret=True)
    before = K.LAUNCHES
    got = K.ssd_chunk(xc, dtc, A_log, Bc, Cc)
    assert K.LAUNCHES == before       # CPU tensors never reach the kernel
    b, nc, q, h, p = xc.shape
    n = Bc.shape[-1]
    assert [tuple(g.shape) for g in got] == [
        (b, nc, q, h, p), (b, nc, h, n, p), (b, nc, h)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_jax_scan_and_models_ssd_chunked(case):
    """The port's chunked scan against the reference's Pallas scan (interpret
    mode) and the jnp ``ssd_chunked`` that ``models/ssm.py`` calls: the same
    algorithm, so elementwise at the kernel tests' tolerance."""
    arrays = _inputs(case, 1)
    chunk = case[-1]
    got = ssd_scan(*_torch(arrays), chunk=chunk)
    assert got.shape == case[:4] and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ssd_scan(*j, chunk=chunk,
                                             interpret=True)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ssd_chunked(*j, chunk=chunk)), **TOL)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_and_ref_match_jax_ref(case):
    """Against the sequential oracle.  The chunked form sums in another
    order than the recurrence: on the shapes of tests/test_kernels.py that
    stays within 1e-4 elementwise, as there; on the zamba2-like case (300
    steps, n = 64, outputs up to ~150) the difference is ~1e-6 of the
    largest output, so there it is held normwise at 1e-4."""
    arrays = _inputs(case, 2)
    chunk = case[-1]
    want = np.asarray(jax_ssd_ref(*(jnp.asarray(a) for a in arrays)))
    port_ref = ssd_ref(*_torch(arrays)).numpy()
    np.testing.assert_allclose(port_ref, want, **TOL)
    got = ssd_scan(*_torch(arrays), chunk=chunk).numpy()
    if case[1] <= 128:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-4, f"max error {err:.3g} of the largest output"


def test_padded_rows_are_neutral():
    """A ragged S is padded with zeros; dt = 0 there, so the first S rows
    equal those of the same scan run on the longer, unpadded sequence."""
    x, dt, A_log, B, C = _torch(_inputs((1, 96, 2, 16, 16, 32), 3))
    full = ssd_scan(x, dt, A_log, B, C, chunk=32)
    part = ssd_scan(x[:, :70], dt[:, :70], A_log, B[:, :70], C[:, :70],
                    chunk=32)
    np.testing.assert_allclose(part.numpy(), full[:, :70].numpy(), **TOL)


def test_chunk_inputs_pad_and_layout():
    x, dt, A_log, B, C = _torch(_inputs((2, 100, 3, 16, 32, 32), 4))
    xc, dtc, Bc, Cc = chunk_inputs(x.to(torch.bfloat16), dt, B, C, 32)
    assert xc.shape == (2, 4, 32, 3, 16) and Bc.shape == (2, 4, 32, 32)
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (xc, dtc, Bc, Cc))
    assert not dtc.reshape(2, 128, 3)[:, 100:].any()
    assert torch.equal(Cc.reshape(2, 128, 32)[:, :100], C)


@pytest.mark.parametrize("bad", ["dt", "A_log", "B", "C", "x"])
def test_wrapper_rejects_bad_shapes(bad):
    shapes = {"x": (1, 2, 8, 2, 16), "dt": (1, 2, 8, 2), "A_log": (2,),
              "B": (1, 2, 8, 16), "C": (1, 2, 8, 16)}
    shapes[bad] = {"x": (1, 2, 8, 2), "dt": (1, 2, 8, 3), "A_log": (3,),
                   "B": (1, 2, 7, 16), "C": (1, 2, 8, 32)}[bad]
    args = [torch.zeros(shapes[k]) for k in ("x", "dt", "A_log", "B", "C")]
    with pytest.raises(ValueError):
        K.ssd_chunk(*args)


def test_choose_variant_routes_by_width_and_chunk():
    """wgmma for n = p = 64 and whole 64-row tiles up to Q = 256 (zamba2-7b's
    mamba layers); simt for the other widths, ragged or long chunks and
    offset views; the twin for CPU tensors."""
    cv = K.choose_variant
    assert cv("cpu", (256, 64, 64), False) == "plain"
    for q in (64, 128, 192, 256):
        assert cv("cuda", (q, 64, 64), False) == "wgmma"
    for shape in [(256, 32, 64), (256, 64, 32), (256, 16, 16), (32, 64, 64),
                  (100, 64, 64), (320, 64, 64), (1024, 64, 64)]:
        assert cv("cuda", shape, False) == "simt", shape
    assert cv("cuda", (256, 64, 64), True) == "simt"


def test_zamba_chunks_route_to_wgmma():
    """zamba2-7b's mamba layer at a full and a ragged S: chunk_inputs pads
    to whole chunks of 256, which the rule sends to wgmma on the card."""
    for s in (4096, 4000, 300):
        x = torch.zeros(1, s, 2, 64)
        B = torch.zeros(1, s, 64)
        xc, dtc, Bc, Cc = chunk_inputs(x, torch.zeros(1, s, 2), B, B, 256)
        assert K.choose_variant("cuda", (xc.shape[2], Bc.shape[-1],
                                         xc.shape[-1]), False) == "wgmma"
        assert K.variant_for(xc, dtc, torch.zeros(2), Bc, Cc) == "plain"


def test_cpu_twin_differentiates():
    """On the CPU the wrapper runs the twin, plain torch ops, so a gradient
    flows (on the card the wrapper refuses one: test_torch_cuda_kernels)."""
    x, dt, A_log, B, C = _torch(_inputs((1, 64, 2, 16, 16, 32), 5))
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, 32)
    xc.requires_grad_(True)
    Bc.requires_grad_(True)
    y, states, _ = K.ssd_chunk(xc, dtc, A_log, Bc, Cc)
    (y.sum() + states.sum()).backward()
    assert xc.grad is not None and bool(xc.grad.isfinite().all())
    assert Bc.grad is not None and bool(Bc.grad.abs().sum() > 0)
