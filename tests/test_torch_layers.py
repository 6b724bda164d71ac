"""Port parity: ``repro_torch.models.layers`` against ``repro.models.layers``
on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

torch.set_num_threads(1)

DTYPES = [("float32", dict(rtol=1e-5, atol=1e-5)),
          ("bfloat16", dict(rtol=2e-2, atol=2e-2))]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype)), \
        torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rmsnorm(dtype, tol):
    r = _rng(1)
    x = r.standard_normal((2, 5, 64), np.float32) * 3
    scale = r.standard_normal(64, np.float32)
    jx, tx = _pair(x, dtype)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    got = tl.rmsnorm(torch.from_numpy(scale), tx, 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_dense(dtype, tol):
    r = _rng(2)
    x = r.standard_normal((2, 5, 64), np.float32)
    w = r.standard_normal((64, 96), np.float32) / 8
    want = jl.dense({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                    getattr(jnp, dtype))
    got = tl.dense(torch.from_numpy(w), torch.from_numpy(x),
                   getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_embed_and_unembed(dtype, tol):
    r = _rng(3)
    table = r.standard_normal((256, 64), np.float32)
    tokens = r.integers(0, 256, (2, 7))
    x = r.standard_normal((2, 3, 64), np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    np.testing.assert_allclose(
        _np(tl.embed(torch.from_numpy(table), torch.from_numpy(tokens), tdt)),
        _np(jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens), jdt)),
        **tol)
    np.testing.assert_allclose(
        _np(tl.unembed(torch.from_numpy(table), torch.from_numpy(x), tdt)),
        _np(jl.unembed({"table": jnp.asarray(table)}, jnp.asarray(x), jdt)),
        **tol)


@pytest.mark.parametrize("head_dim,theta", [(16, 500000.0), (128, 10000.0)])
def test_rope_frequencies(head_dim, theta):
    np.testing.assert_allclose(_np(tl.rope_frequencies(head_dim, theta)),
                               _np(jl.rope_frequencies(head_dim, theta)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_apply_rope(dtype, tol):
    r = _rng(4)
    x = r.standard_normal((2, 200, 4, 16), np.float32)
    pos = np.broadcast_to(np.arange(200)[None], (2, 200)).copy()
    jx, tx = _pair(x, dtype)
    want = jl.apply_rope(jx, jnp.asarray(pos), 500000.0)
    got = tl.apply_rope(tx, torch.from_numpy(pos), 500000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_swiglu(dtype, tol):
    r = _rng(5)
    x = r.standard_normal((2, 5, 64), np.float32)
    w = {"gate": r.standard_normal((64, 128), np.float32) / 8,
         "up": r.standard_normal((64, 128), np.float32) / 8,
         "down": r.standard_normal((128, 64), np.float32) / 11}
    want = jl.swiglu({k: {"kernel": jnp.asarray(v)} for k, v in w.items()},
                     jnp.asarray(x), getattr(jnp, dtype))
    got = tl.swiglu({k: torch.from_numpy(v) for k, v in w.items()},
                    torch.from_numpy(x), getattr(torch, dtype))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_rounds_like_jax(dtype):
    x = np.random.default_rng(6).standard_normal((4096,), np.float32) * 4
    jx, tx = _pair(x, dtype)
    want = np.asarray(jax.nn.silu(jx), np.float32)
    got = _np(tl.silu(tx))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:   # exp in float32 differs between the libraries by an ulp
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_inits_follow_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 256, 512)
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert abs(w.std().item() * 16 - 1) < 0.02 and abs(w.mean().item()) < 2e-3
    e = tl.embedding_init(gen, 512, 256, dtype=torch.bfloat16)
    assert e.shape == (512, 256) and e.dtype == torch.bfloat16
    assert abs(e.float().std().item() / 0.02 - 1) < 0.02
    s = tl.swiglu_init(gen, 64, 128)
    assert {k: tuple(v.shape) for k, v in s.items()} == {
        "gate": (64, 128), "up": (64, 128), "down": (128, 64)}
    assert torch.equal(tl.rmsnorm_init(64, device="cpu"), torch.ones(64))
    # one generator, one stream: the same seed gives the same weights
    again = tl.dense_init(torch.Generator().manual_seed(0), 256, 512)
    assert torch.equal(w, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_and_log_sigmoid_round_like_jax(dtype):
    x = np.random.default_rng(7).standard_normal((4096,), np.float32) * 8
    x = np.concatenate([x, [np.inf, -np.inf, 0.0, 30.0, -30.0]]) \
        .astype(np.float32)
    jx, tx = _pair(x, dtype)
    for jfn, tfn in ((jax.nn.softplus, tl.softplus),
                     (jax.nn.log_sigmoid, tl.log_sigmoid)):
        want = np.asarray(jfn(jx), np.float32)
        got = _np(tfn(tx))
        assert tfn(tx).dtype == tx.dtype
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:   # exp and log1p in float32 differ between the libraries
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
