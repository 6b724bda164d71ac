"""Port parity for the dense LM end to end: a reduced llama3.2-3b with the
reference's parameters carried across by ``repro_torch.convert``, through the
prefill step, the KV-cache prefill and decode, and the greedy server loop.

The port's MLP computes its gate/up half as the fused SwiGLU kernel does
(fp32 products and epilogue, one rounding to bf16), so the reference's MLP
is held to the same function here: ``repro.models.layers.swiglu`` runs
through the reference's own ``swiglu_ref`` (the kernel's oracle) for the
length of this module.  In bf16 the reference's op-by-op jnp MLP rounds g, u
and each step of silu, about an ulp of h away; with the kernel's function
on both sides the port is bitwise equal to the reference run op by op.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.kernels.fused_swiglu.ref import swiglu_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)

torch.set_num_threads(1)

OVERRIDES = dict(attention_impl="pallas", block_q=64, block_kv=64)


def _kernel_swiglu(params, x, compute_dtype=jnp.bfloat16, *, skip=False):
    """The reference's ``layers.swiglu`` with its gate/up half computed by
    ``swiglu_ref``, the fused SwiGLU kernel's function."""
    dt = compute_dtype
    h = swiglu_ref(x.astype(dt).reshape(-1, x.shape[-1]),
                   params["gate"]["kernel"].astype(dt),
                   params["up"]["kernel"].astype(dt))
    return jax_layers.dense(params["down"], h.reshape(*x.shape[:-1], -1), dt)


@pytest.fixture(scope="module", autouse=True)
def reference_mlp_is_the_kernels_function():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "swiglu", _kernel_swiglu)
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    """float32: elementwise to 1e-4.  bfloat16: the largest error within
    2e-2 of the largest value.  Each op of the port rounds to bf16 exactly
    as the reference's op does (tests/test_torch_layers.py), but compiled
    JAX keeps some fused bf16 intermediates in f32, and one-ulp flips grow
    through the layers into a few elements past an elementwise 2e-2."""
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 2e-2, f"max error {err:.3g} of the largest value"


def _build_pair(dtype):
    """(dtype, jax model, jax params, port model, port params)."""
    jcfg = jax_reduce(JAX_ARCHS["llama3.2-3b"], dtype=dtype, **OVERRIDES)
    tcfg = reduce_config(ARCHS["llama3.2-3b"], dtype=dtype, **OVERRIDES)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return dtype, jm, jp, build_model(tcfg), params_from_numpy(tree, tcfg,
                                                               "cpu")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    return _build_pair(request.param)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.int32)


def test_convert_carries_every_parameter(pair):
    dtype, _, jp, tm, tp = pair
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    assert len(tp.blocks) == tm.cfg.n_layers
    blocks = jp["blocks"]
    for i, blk in enumerate(tp.blocks):
        np.testing.assert_array_equal(
            _np(blk.attn["wk"]),
            np.asarray(blocks["attn"]["wk"]["kernel"][i].astype(dtype),
                       np.float32))
        assert blk.ln1.dtype == torch.float32
        assert blk.mlp["down"].dtype == getattr(torch, dtype)
    assert not any(p.requires_grad for p in tp.parameters())


def test_prefill_step_logits_match_jax(pair):
    """lm_forward at S = 200 > block_q: the flash path in every layer."""
    dtype, jm, jp, tm, tp = pair
    toks = _tokens((2, 200))
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 200, 256) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_kv_prefill_and_decode_match_jax(pair):
    dtype, jm, jp, tm, tp = pair
    b, plen, max_seq = 2, 10, 20
    toks = _tokens((b, plen), 1)
    jstate = jm.decode_init(b, max_seq)
    jl, jstate = jax.jit(jm.prefill_fn)(jp, jstate, jnp.asarray(toks))
    tstate = tm.decode_init(b, max_seq, device="cpu")
    tl, tstate = tm.prefill_fn(tp, tstate, torch.from_numpy(toks))
    _close(tl, jl, dtype)
    for key in ("k", "v"):
        _close(tstate[key], jstate[key], dtype)
    jdecode = jax.jit(jm.decode_fn)
    tdecode = make_decode_step(tm)
    nxt = _tokens((4, b), 2)
    for i in range(4):
        ln = np.full((b,), plen + i, np.int32)
        jl, jstate = jdecode(jp, jstate, jnp.asarray(nxt[i]),
                             jnp.asarray(ln))
        tl, tstate = tdecode(tp, tstate, {
            "tokens": torch.from_numpy(nxt[i]),
            "cache_len": torch.from_numpy(ln)})
        _close(tl, jl, dtype)
    for key in ("k", "v"):
        _close(tstate[key], jstate[key], dtype)


def test_greedy_ids_match_jax_generate_loop():
    """The reference launcher's loop (repro/launch/serve.py run_generate)
    against the port's server code: identical token ids, in float32 since
    bf16 rounding can flip near-tied random-weight logits."""
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


def test_prefill_equals_sequential_fill(pair):
    """The invariant of tests/test_serve.py:551 on the port itself."""
    dtype, _, _, tm, tp = pair
    b, plen, max_seq = 2, 10, 20
    prompts = torch.from_numpy(_tokens((b, plen), 4))
    decode = make_decode_step(tm)
    seq = tm.decode_init(b, max_seq, device="cpu")
    for t in range(plen):
        l_seq, seq = decode(tp, seq, {
            "tokens": prompts[:, t],
            "cache_len": torch.full((b,), t, dtype=torch.int32)})
    pre = tm.decode_init(b, max_seq, device="cpu")
    l_pre, pre = tm.prefill_fn(tp, pre, prompts)
    _close(l_pre, l_seq, dtype)
    for key in ("k", "v"):
        _close(pre[key], seq[key], dtype)
    # the two caches continue decoding alike
    cur = l_pre[:, :256].argmax(-1).to(torch.int32)
    ln = torch.full((b,), plen, dtype=torch.int32)
    a, _ = decode(tp, seq, {"tokens": cur, "cache_len": ln})
    c, _ = decode(tp, pre, {"tokens": cur, "cache_len": ln})
    _close(c, a, dtype)


def test_sequential_prefill_generates_the_same_ids():
    cfg = reduce_config(ARCHS["llama3.2-3b"], dtype="float32", **OVERRIDES)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    prompts = torch.from_numpy(_tokens((2, 9), 5))
    a = serve.generate(model, params, prompts, 5)
    c = serve.generate(model, params, prompts, 5, sequential_prefill=True)
    assert (a.mode, c.mode) == ("batched", "sequential")
    assert torch.equal(a.tokens, c.tokens)


def test_generate_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "generate", "--arch", "llama3.2-3b", "--test-mesh",
        "--device", "cpu", "--requests", "2", "--prompt-len", "8",
        "--gen-tokens", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill (batched)" in out and "tok/s" in out
    assert "generated token ids (first request):" in out


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_other_families_name_their_slice(arch):
    """The multimodal families are served by their own slice
    (``models/multimodal.py``): a Model with no batched prefill, whose
    server fills the cross-attentive state token by token."""
    cfg = reduce_config(ARCHS[arch])
    model = build_model(cfg)
    assert model.cfg is cfg and model.prefill_fn is None
    assert all(callable(f) for f in (model.init, model.forward,
                                     model.loss_fn, model.decode_init,
                                     model.decode_fn))
