"""Port parity: ``repro_torch.models.attention`` against
``repro.models.attention`` (the Pallas kernel in interpret mode) on the same
numpy inputs and parameters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models.model import reduce_config  # noqa: E402

torch.set_num_threads(1)

DTYPES = [("float32", dict(rtol=1e-5, atol=1e-5)),
          ("bfloat16", dict(rtol=2e-2, atol=2e-2))]


def _cfgs(**kw):
    kw = dict(dict(block_q=64, block_kv=64), **kw)
    return (jax_reduce(JAX_ARCHS["llama3.2-3b"], **kw),
            reduce_config(ARCHS["llama3.2-3b"], **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype)), \
        torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _params(jcfg, seed=0):
    jp = ja.attention_init(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v["kernel"]))
                for k, v in jp.items()}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_naive_attention(dtype, tol, causal):
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((2, 12, 4, 16), np.float32)
               for _ in range(3))
    kv_len = np.array([5, 12], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jax.jit(lambda q, k, v, n: ja.naive_attention(
        q, k, v, causal=causal, q_offset=3, kv_len=n))(
        jq, jk, jv, jnp.asarray(kv_len))
    got = ta.naive_attention(tq, tk, tv, causal=causal, q_offset=3,
                             kv_len=torch.from_numpy(kv_len))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention(dtype, tol, causal):
    r = np.random.default_rng(1)
    q, k, v = (r.standard_normal((2, 200, 4, 16), np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jax.jit(lambda q, k, v: ja.blockwise_attention(
        q, k, v, causal=causal, block_q=64, block_kv=48))(jq, jk, jv)
    got = ta.blockwise_attention(tq, tk, tv, causal=causal, block_q=64,
                                 block_kv=48)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("impl,seq", [
    ("naive", 200),        # naive branch
    ("pallas", 48),        # s <= block_q: naive branch
    ("pallas", 200),       # flash kernel branch (plain twin on the CPU)
    ("blockwise", 200),    # blockwise branch
])
def test_attention_forward_dispatch(dtype, tol, impl, seq):
    jcfg, tcfg = _cfgs(attention_impl=impl, dtype=dtype)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(2).standard_normal((2, seq, 64), np.float32)
    pos = np.broadcast_to(np.arange(seq)[None], (2, seq)).copy()
    jx, tx = _pair(x, dtype)
    want = jax.jit(lambda p, x, pos: ja.attention_forward(
        jcfg, p, x, positions=pos))(jp, jx, jnp.asarray(pos))
    got = ta.attention_forward(tcfg, tp, tx, positions=torch.from_numpy(pos))
    assert got.shape == (2, seq, 64) and got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_attention_forward_rejects_unported_impl():
    """An unknown impl raises; "skip", the reference's cost-probe mode, is
    ported and computes the reference's o = q + v (GQA: v repeated)."""
    jcfg, tcfg = _cfgs(attention_impl="skip", dtype="float32", n_kv_heads=2)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(3).standard_normal((2, 8, 64), np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).copy()
    want = jax.jit(lambda p, x, pos: ja.attention_forward(
        jcfg, p, x, positions=pos))(jp, jnp.asarray(x), jnp.asarray(pos))
    got = ta.attention_forward(tcfg, tp, torch.from_numpy(x),
                               positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    _, bad = _cfgs(attention_impl="nope", dtype="float32", n_kv_heads=2)
    with pytest.raises(ValueError, match="nope"):
        ta.attention_forward(bad, tp, torch.zeros(1, 8, 64),
                             positions=torch.arange(8)[None])


def test_attention_forward_pallas_calls_flash_wrapper(monkeypatch):
    """On the pallas branch the wrapper gets the un-repeated GQA K/V."""
    _, tcfg = _cfgs(attention_impl="pallas", dtype="float32", n_kv_heads=2)
    _, tp = _params(_cfgs(attention_impl="pallas", n_kv_heads=2)[0])
    seen = []
    real = K.flash_attention_fwd

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ta, "flash_attention",
                        lambda q, k, v, **kw: spy(
                            q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), **kw).transpose(1, 2))
    x = torch.randn(1, 100, 64)
    ta.attention_forward(tcfg, tp, x, positions=torch.arange(100)[None])
    assert seen == [((1, 4, 100, 16), (1, 2, 100, 16))]


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_prefill_attention(dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg, 1)
    x = np.random.default_rng(3).standard_normal((2, 10, 64), np.float32)
    jx, tx = _pair(x, dtype)
    jc = ja.init_kv_cache(jcfg, 2, 20, 1, getattr(jnp, dtype))
    tc = ta.init_kv_cache(tcfg, 2, 20, 1, getattr(torch, dtype),
                          device="cpu")
    want = jax.jit(lambda *a: ja.prefill_attention(jcfg, *a))(
        jp, jx, jc["k"][0], jc["v"][0])
    got = ta.prefill_attention(tcfg, tp, tx, tc["k"][0], tc["v"][0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    assert got[1].data_ptr() == tc["k"].data_ptr()     # written in place


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_decode_attention(dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jp, tp = _params(jcfg, 2)
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 1, 64), np.float32)
    kv = jcfg.n_kv_heads
    ck = r.standard_normal((2, 16, kv, 16), np.float32)
    cv = r.standard_normal((2, 16, kv, 16), np.float32)
    cache_len = np.array([5, 9], np.int32)
    ck[0, 5:] = cv[0, 5:] = 0        # positions >= cache_len are empty
    ck[1, 9:] = cv[1, 9:] = 0
    (jx, tx), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (x, ck, cv))
    want = jax.jit(lambda p, x, k, v, n: ja.decode_attention(
        jcfg, p, x, k, v, cache_len=n))(jp, jx, jk, jv,
                                        jnp.asarray(cache_len))
    got = ta.decode_attention(tcfg, tp, tx, tk, tv,
                              cache_len=torch.from_numpy(cache_len))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol)
