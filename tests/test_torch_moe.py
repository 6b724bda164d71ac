"""Port parity for the MoE family: ``moe_forward`` (both dispatch
implementations, einsum and gather) against the reference's, including a
capacity drop and the ``MAX_GROUP`` regroup, then a reduced
granite-moe-1b-a400m (4 layers, d 64, 4 experts top-2, expert width 32)
with the reference's parameters carried across by ``repro_torch.convert``,
through the prefill step, the KV-cache prefill and decode, and the greedy
server loop.

float32 is held elementwise at 1e-4 against the compiled reference.
bfloat16 is held normwise (``max|a-b| / max|b| <= 2e-2``) against the
reference run op by op (``jax.disable_jit``).  The router picks each
token's top-k experts, so a one-ulp difference in the router's input can
flip a near-tied choice and change that token's output by O(1); the
compiled reference, which keeps fused bf16 intermediates in f32, differs
from its own op-by-op run by ~0.5 normwise on the reduced model's logits.
The routing itself (top-k mask and weights) is compared in fp32, exactly.

The port's expert FFN computes its gate/up half as the fused SwiGLU kernel
does (fp32 products and epilogue, one rounding to bf16), where the
reference's op-by-op einsums round g, u and each step of silu to bf16.
One layer stays within 2e-2 of the reference as it is.  Through the
reduced model at S = 200 those ulps flip the expert choice of 3-4 of the
400 tokens in each layer after the first, which takes the logits ~0.3
from the op-by-op reference.  The model-level bf16 tests therefore hold
the port to the reference with its expert FFN computed as the kernel
computes it (``_KernelFFN``: the gate and up einsums in fp32, the hidden
rounded once before the down einsum), the function the reference's own
``swiglu_ref`` computes.

Batched prefill is not held equal to a sequential fill: a group of S
tokens drops the tokens beyond each expert's capacity, a decode step (one
token, capacity 1) drops none, in the reference as in the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as K  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
OVERRIDES = dict(attention_impl="pallas", block_q=64, block_kv=64)
IMPLS = ["einsum", "gather"]
DTYPES = ["float32", "bfloat16"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 2e-2, f"max error {err:.3g} of the largest value"


def _reference(dtype, fn, *args):
    """The reference's result: compiled in float32, op by op in bf16."""
    if dtype == "float32":
        return jax.jit(fn)(*args)
    with jax.disable_jit():
        return fn(*args)


class _KernelFFN:
    """``jax.numpy`` as the reference's ``models/moe.py`` sees it, with the
    expert FFN's two einsums computing the fused SwiGLU kernel's function:
    gate and up in fp32 (exact products of the bf16 inputs, fp32 sums), so
    ``silu(gate) * up`` runs in fp32, and the hidden rounded once, to the
    weights' dtype, before the down einsum."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, a, b, **kw):
        if spec == "gecd,edf->gecf":
            return jnp.einsum(spec, a.astype(jnp.float32),
                              b.astype(jnp.float32), **kw)
        if spec == "gecf,efd->gecd":
            return jnp.einsum(spec, a.astype(b.dtype), b, **kw)
        return jnp.einsum(spec, a, b, **kw)


def _model_reference(dtype, fn, *args):
    """:func:`_reference` of a whole model; in bf16 with the reference's
    expert FFN computing the kernel's function (``_KernelFFN``)."""
    if dtype == "float32":
        return _reference(dtype, fn, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe, "jnp", _KernelFFN())
        return _reference(dtype, fn, *args)


def _configs(**kw):
    """(port, reference) reduced granite-moe configs with ``kw``."""
    return (reduce_config(ARCHS[ARCH], **kw),
            jax_reduce(JAX_ARCHS[ARCH], **kw))


def _layer_params(jcfg, dtype, seed=0):
    """The reference's ``moe_init`` and the same parameters as the port
    holds them: the router kernel float32, the experts in ``dtype``."""
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    dt = getattr(torch, dtype)
    tp = {"router": torch.from_numpy(np.array(jp["router"]["kernel"]))}
    tp.update({n: torch.from_numpy(np.array(jp[n])).to(dt)
               for n in ("gate", "up", "down")})
    return jp, tp


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x, getattr(jnp, dtype)))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_layer_matches_jax(impl, dtype):
    """Output and aux loss of one layer, 2 groups of 40 tokens, through
    the fused SwiGLU twin in one call for all experts."""
    tcfg, jcfg = _configs(dtype=dtype, moe_impl=impl)
    jp, tp = _layer_params(jcfg, dtype)
    tx, jx = _x((2, 40, 64), dtype)
    want, want_aux = _reference(dtype, lambda p, x: jax_moe.moe_forward(
        jcfg, p, x), jp, jx)
    before = K.LAUNCHES
    got, aux = moe.moe_forward(tcfg, tp, tx)
    assert K.LAUNCHES == before          # CPU tensors: the plain twin
    assert got.shape == (2, 40, 64) and got.dtype == tx.dtype
    assert aux.dtype == torch.float32
    _close(got, want, dtype)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_routing_matches_jax(dtype):
    """The fp32 router on the same (bf16 or f32) input: the top-k mask
    exactly, the renormalised weights to fp32 rounding."""
    tcfg, jcfg = _configs(dtype=dtype)
    jp, tp = _layer_params(jcfg, dtype)
    tx, jx = _x((2, 40, 64), dtype, seed=1)
    jprobs = jax.nn.softmax(jx.astype(jnp.float32)
                            @ jp["router"]["kernel"], axis=-1)
    tprobs = torch.softmax(tx.float() @ tp["router"], dim=-1)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-6, atol=1e-7)
    jmask, jw = jax_moe._top_k_mask(jprobs, jcfg.top_k)
    tmask, tw = moe._top_k_mask(tprobs, tcfg.top_k)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("impl", IMPLS)
def test_tight_capacity_drops_the_same_tokens(impl):
    """tests/test_moe_impls.py:54's case: capacity factor 0.5, so experts
    overflow and both packages must drop the same tokens."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, moe_d_ff=64, vocab=64, n_experts=8,
              top_k=2, dtype="float32", capacity_factor=0.5, moe_impl=impl)
    tcfg, jcfg = ModelConfig(**kw), JaxConfig(**kw)
    jp, tp = _layer_params(jcfg, "float32")
    tx, jx = _x((1, 32, 32), "float32", seed=2)
    # the case is a real overflow: some expert is chosen by more tokens
    # than its capacity of ceil(32 * 2 / 8 * 0.5) = 4
    mask, _ = moe._top_k_mask(torch.softmax(tx @ tp["router"], -1), 2)
    assert int(mask.sum(dim=1).max()) > 4
    want, _ = jax.jit(lambda p, x: jax_moe.moe_forward(jcfg, p, x))(jp, jx)
    got, _ = moe.moe_forward(tcfg, tp, tx)
    _close(got, want, "float32")


@pytest.mark.parametrize("impl", IMPLS)
def test_max_group_regroup(impl):
    """S = 8192 > MAX_GROUP: two dispatch groups of 4096, each with its
    own capacity, as in the reference; the same as routing the two halves
    as separate sequences."""
    tcfg, jcfg = _configs(dtype="float32", moe_impl=impl)
    jp, tp = _layer_params(jcfg, "float32", seed=3)
    tx, jx = _x((1, 2 * moe.MAX_GROUP, 64), "float32", seed=3)
    want, want_aux = jax.jit(lambda p, x: jax_moe.moe_forward(
        jcfg, p, x))(jp, jx)
    got, aux = moe.moe_forward(tcfg, tp, tx)
    _close(got, want, "float32")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    halves, _ = moe.moe_forward(tcfg, tp, tx.reshape(2, moe.MAX_GROUP, 64))
    np.testing.assert_array_equal(got.numpy(),
                                  halves.reshape(got.shape).numpy())
    with pytest.raises(ValueError, match="does not split"):
        moe.moe_forward(tcfg, tp, tx[:, :moe.MAX_GROUP + 8])


def test_moe_ffn_skip_and_unknown_impls_are_refused():
    """Unknown dispatch implementations are refused; ``moe_ffn_skip``, the
    reference's cost-probe mode, is ported: the einsum dispatch bypasses
    the expert FFN (expert_out = expert_in) as the reference's does."""
    tcfg, jcfg = _configs(dtype="float32")
    jp, tp = _layer_params(jcfg, "float32")
    tx, jx = _x((2, 8, 64), "float32")
    skip_t = dataclasses.replace(tcfg, moe_ffn_skip=True)
    skip_j = dataclasses.replace(jcfg, moe_ffn_skip=True)
    want, want_aux = jax.jit(lambda p, x: jax_moe.moe_forward(
        skip_j, p, x))(jp, jx)
    got, aux = moe.moe_forward(skip_t, tp, tx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.moe_forward(dataclasses.replace(tcfg, moe_impl="sort"), tp, tx)


# ---------------------------------------------------------------------------
# the reduced granite-moe-1b-a400m end to end
# ---------------------------------------------------------------------------

def _build_pair(dtype):
    """(dtype, jax model, jax params, port model, port params)."""
    tcfg, jcfg = _configs(dtype=dtype, **OVERRIDES)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return dtype, jm, jp, build_model(tcfg), params_from_numpy(tree, tcfg,
                                                               "cpu")


@pytest.fixture(scope="module", params=DTYPES)
def pair(request):
    return _build_pair(request.param)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.int32)


def test_config_and_model():
    """granite-moe-1b-a400m: 24 layers, d 1024, 32 experts top-8 of width
    512, vocab 49155, tied embeddings, 1,334,627,328 parameters; it
    shares the dense LM's model, batched prefill included."""
    cfg = ARCHS[ARCH]
    assert (cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.top_k,
            cfg.moe_d_ff, cfg.vocab) == (24, 1024, 32, 8, 512, 49155)
    assert cfg.tie_embeddings and cfg.head_dim == 64
    assert cfg.param_count() == 1_334_627_328
    # the reference's tree adds the padded vocab rows and ln_f; chip_smoke.py
    # holds the port's full-size init to this count
    shapes = jax.eval_shape(jax_build(JAX_ARCHS[ARCH]).init,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes)) == 1_334_887_424
    model = build_model(reduce_config(cfg))
    assert model.prefill_fn is not None
    params = model.init(0, device="cpu")
    blk = params.blocks[0]
    assert not hasattr(blk, "mlp") and params.unembed is None
    assert blk.moe["router"].shape == (64, 4)
    assert blk.moe["router"].dtype == torch.float32
    assert blk.moe["gate"].shape == blk.moe["up"].shape == (4, 64, 32)
    assert blk.moe["down"].shape == (4, 32, 64)
    assert blk.moe["gate"].dtype == torch.bfloat16


def test_convert_carries_every_parameter(pair):
    dtype, _, jp, tm, tp = pair
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    assert len(tp.blocks) == tm.cfg.n_layers and tp.unembed is None
    ref = jp["blocks"]["moe"]
    for i, blk in enumerate(tp.blocks):
        np.testing.assert_array_equal(_np(blk.moe["router"]),
                                      np.asarray(ref["router"]["kernel"][i]))
        assert blk.moe["router"].dtype == torch.float32
        for name in ("gate", "up", "down"):
            np.testing.assert_array_equal(
                _np(blk.moe[name]),
                np.asarray(ref[name][i].astype(dtype), np.float32))
            assert blk.moe[name].dtype == getattr(torch, dtype)
    assert not any(p.requires_grad for p in tp.parameters())


def test_prefill_step_logits_match_jax(pair):
    """lm_forward at S = 200 > block_q: the flash path and the MoE layer
    (capacity 125 of 200 tokens per expert) in every block."""
    dtype, jm, jp, tm, tp = pair
    toks = _tokens((2, 200))
    want = _model_reference(dtype, jm.forward, jp,
                            {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 200, 256) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_kv_prefill_and_decode_match_jax(pair):
    """The batched prefill (``lm_prefill``) into the KV cache, then decode
    steps, against the reference's ``prefill_fn`` and ``decode_fn``."""
    dtype, jm, jp, tm, tp = pair
    b, plen, max_seq = 2, 10, 20
    toks = _tokens((b, plen), 1)
    jstate = jm.decode_init(b, max_seq)
    jl, jstate = _model_reference(dtype, jm.prefill_fn, jp, jstate,
                                  jnp.asarray(toks))
    tstate = tm.decode_init(b, max_seq, device="cpu")
    tl, tstate = tm.prefill_fn(tp, tstate, torch.from_numpy(toks))
    _close(tl, jl, dtype)
    for key in ("k", "v"):
        _close(tstate[key], jstate[key], dtype)
    tdecode = make_decode_step(tm)
    nxt = _tokens((4, b), 2)
    for i in range(4):
        ln = np.full((b,), plen + i, np.int32)
        jl, jstate = _model_reference(dtype, jm.decode_fn, jp, jstate,
                                      jnp.asarray(nxt[i]), jnp.asarray(ln))
        tl, tstate = tdecode(tp, tstate, {
            "tokens": torch.from_numpy(nxt[i]),
            "cache_len": torch.from_numpy(ln)})
        _close(tl, jl, dtype)
    for key in ("k", "v"):
        _close(tstate[key], jstate[key], dtype)


def test_greedy_ids_match_jax_generate_loop():
    """The reference launcher's loop (repro/launch/serve.py run_generate:
    the batched prefill, then greedy decode) against the port's server
    code: identical token ids, in float32 since bf16 rounding can flip
    near-tied random-weight logits."""
    _, jm, jp, tm, tp = _build_pair("float32")
    b, plen, gen = 3, 12, 6
    prompts = _tokens((b, plen), 3)
    decode = jax.jit(jm.decode_fn)
    state = jm.decode_init(b, plen + gen + 8)
    logits, state = jax.jit(jm.prefill_fn)(jp, state, jnp.asarray(prompts))
    cur = jnp.argmax(logits[:, :256], axis=-1).astype(jnp.int32)
    want = []
    for i in range(gen):
        want.append(np.asarray(cur))
        logits, state = decode(jp, state, cur,
                               jnp.full((b,), plen + i, jnp.int32))
        cur = jnp.argmax(logits[:, :256], axis=-1).astype(jnp.int32)
    got = serve.generate(tm, tp, torch.from_numpy(prompts), gen)
    assert got.mode == "batched"
    np.testing.assert_array_equal(got.tokens.numpy(), np.stack(want, 1))


def test_generate_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "generate", "--arch", ARCH, "--test-mesh", "--device", "cpu",
        "--requests", "2", "--prompt-len", "8", "--gen-tokens", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill (batched)" in out and "tok/s" in out
    assert "generated token ids (first request):" in out
