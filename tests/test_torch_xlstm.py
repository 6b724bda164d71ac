"""Port parity for the xLSTM LM end to end: a reduced xlstm-1.3b (4 blocks,
``slstm_every=2``: two groups of one mLSTM block and one sLSTM block, d 64,
4 heads of p = 32) with the reference's parameters carried across by
``repro_torch.convert``, through one mLSTM and one sLSTM layer, the prefill
step (S = 300: two mLSTM chunks of 256, the last ragged), the sequential
state fill and decode, and the greedy server loop.

float32 is held elementwise at 1e-4 against the compiled reference.
bfloat16 is held normwise (``max|a-b| / max|b| <= 2e-2``): the prefill
logits against the compiled reference, the layers and the decode steps
against the reference run op by op (``jax.disable_jit``).  Compiled XLA
keeps fused bf16 intermediates in f32 (ROADMAP queue C); through the sLSTM
recurrence that leaves the compiled decode state 2.3e-2 from its own
op-by-op run after six steps, while the port, which rounds per op, matches
the op-by-op run to 1e-7.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer, xlstm  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)

torch.set_num_threads(1)

SEQ = 300          # two mLSTM chunks of 256, the last ragged


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


def _build_pair(dtype):
    """(dtype, jax model, jax params, port model, port params)."""
    jcfg = jax_reduce(JAX_ARCHS["xlstm-1.3b"], dtype=dtype)
    tcfg = reduce_config(ARCHS["xlstm-1.3b"], dtype=dtype)
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


def test_layout_and_full_size():
    """xlstm-1.3b: 6 groups of 7 mLSTM blocks and 1 sLSTM block, 4 heads of
    p = 1024; the reduced config: 2 groups of 1 + 1."""
    cfg = ARCHS["xlstm-1.3b"]
    assert transformer.xlstm_layout(cfg) == (6, 7)
    assert xlstm._widths(cfg) == (4096, 4, 1024)
    assert transformer.padded_vocab(cfg) == 50432
    red = reduce_config(cfg)
    assert transformer.xlstm_layout(red) == (2, 1)
    # the stack without sLSTM blocks: one group of mLSTM blocks alone
    bare = reduce_config(cfg, slstm_every=0)
    assert transformer.xlstm_layout(bare) == (1, 4)
    assert transformer.xlstm_counts(bare) == (4, 0)
    assert build_model(red).prefill_fn is None   # recurrent: sequential fill
    # the parameter count of the full model, from the reference's shapes
    jcfg = JAX_ARCHS["xlstm-1.3b"]
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes))
    assert n_ref == 3_605_666_128
    state = build_model(red).decode_init(2, 8, device="cpu")
    assert state["m"]["C"].shape == (2, 2, 4, 32, 32)
    assert state["s"]["h"].shape == (2, 2, 64)


def test_convert_carries_every_parameter(pair):
    dtype, _, jp, tm, tp = pair
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    assert len(tp.mblocks) == 2 and len(tp.sblocks) == 2
    dt = getattr(torch, dtype)
    for i, blk in enumerate(tp.mblocks):
        ref = jp["mblocks"]["mlstm"]
        np.testing.assert_array_equal(
            _np(blk.mlstm["wq"]),
            np.asarray(ref["wq"]["kernel"][i].astype(dtype), np.float32))
        np.testing.assert_array_equal(_np(blk.mlstm["w_if"]),
                                      np.asarray(ref["w_if"][i]))
        for name in ("up_l", "up_r", "wq", "wk", "wv", "down"):
            assert blk.mlstm[name].dtype == dt
        for name in ("w_if", "b_if", "norm"):
            assert blk.mlstm[name].dtype == torch.float32
    for i, blk in enumerate(tp.sblocks):
        ref = jp["sblocks"]["slstm"]
        np.testing.assert_array_equal(
            _np(blk.slstm["wh"]),
            np.asarray(ref["wh"]["kernel"][i].astype(dtype), np.float32))
        assert blk.slstm["proj"].dtype == dt
        assert blk.slstm["bias"].dtype == torch.float32
        assert blk.ln.dtype == torch.float32
    assert tp.embed.dtype == dt and tp.unembed.dtype == dt
    assert not any(p.requires_grad for p in tp.parameters())


def test_mlstm_layer_matches_jax(pair):
    """One mLSTM layer: ``mlstm_forward`` at S = 300 (two chunks, ragged)
    and a few ``mlstm_decode_step``s, state included."""
    dtype, jm, jp, tm, tp = pair
    jcfg, tcfg = jm.cfg, tm.cfg
    jparams = jax.tree_util.tree_map(lambda a: a[1], jp["mblocks"]["mlstm"])
    tparams = tp.mblocks[1].mlstm
    x = np.random.default_rng(5).standard_normal((2, SEQ, 64)) \
        .astype(np.float32)
    want = _reference(dtype, lambda p, v: jax_xlstm.mlstm_forward(jcfg, p, v),
                      jparams, jnp.asarray(x).astype(dtype))
    got = xlstm.mlstm_forward(tcfg, tparams,
                              torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == (2, SEQ, 64)
    _close(got, want, dtype)

    js = jax.tree_util.tree_map(lambda a: a[0],
                                jax_xlstm.init_mlstm_state(jcfg, 2, 1))
    ts = {k: v[0] for k, v in
          xlstm.init_mlstm_state(tcfg, 2, 1, device="cpu").items()}
    jst, tst = (js["C"], js["n"], js["m"]), (ts["C"], ts["n"], ts["m"])
    for t in range(4):
        xt = x[:, t:t + 1]
        jy, *jst = _reference(
            dtype, lambda p, v, C, n, m: jax_xlstm.mlstm_decode_step(
                jcfg, p, v, C, n, m),
            jparams, jnp.asarray(xt).astype(dtype), *jst)
        ty, *tst = xlstm.mlstm_decode_step(
            tcfg, tparams, torch.from_numpy(xt).to(getattr(torch, dtype)),
            *tst)
        _close(ty, jy, dtype)
    for g, w in zip(tst, jst):
        _close(g, w, dtype)


def test_slstm_layer_matches_jax(pair):
    """One sLSTM layer: the recurrence over S = 64 steps and a few decode
    steps, state included."""
    dtype, jm, jp, tm, tp = pair
    jcfg, tcfg = jm.cfg, tm.cfg
    jparams = jax.tree_util.tree_map(lambda a: a[0], jp["sblocks"]["slstm"])
    tparams = tp.sblocks[0].slstm
    x = np.random.default_rng(6).standard_normal((2, 64, 64)) \
        .astype(np.float32)
    want = _reference(dtype, lambda p, v: jax_xlstm.slstm_forward(jcfg, p, v),
                      jparams, jnp.asarray(x).astype(dtype))
    got = xlstm.slstm_forward(tcfg, tparams,
                              torch.from_numpy(x).to(getattr(torch, dtype)))
    _close(got, want, dtype)

    js = jax_xlstm.init_slstm_state(jcfg, 2, 1)
    jst = [js[k][0] for k in "hcnm"]
    ts = xlstm.init_slstm_state(tcfg, 2, 1, device="cpu")
    tst = [ts[k][0] for k in "hcnm"]
    for t in range(4):
        xt = x[:, t:t + 1]
        jy, *jst = _reference(
            dtype, lambda p, v, *s: jax_xlstm.slstm_decode_step(
                jcfg, p, v, *s),
            jparams, jnp.asarray(xt).astype(dtype), *jst)
        ty, *tst = xlstm.slstm_decode_step(
            tcfg, tparams, torch.from_numpy(xt).to(getattr(torch, dtype)),
            *tst)
        _close(ty, jy, dtype)
    for g, w in zip(tst, jst):
        _close(g, w, dtype)


def test_mixer_skip_is_not_ported():
    """``mixer_skip``, the reference's cost-probe mode, is ported: the mLSTM
    block bypasses the scan (y = q + v in float32) as the reference's
    does, and the outputs agree in fp32."""
    jcfg = jax_reduce(JAX_ARCHS["xlstm-1.3b"], mixer_skip=True,
                      dtype="float32")
    tcfg = reduce_config(ARCHS["xlstm-1.3b"], mixer_skip=True,
                         dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    x = np.random.default_rng(6).standard_normal((2, 40, 64)) \
        .astype(np.float32)
    want = jax.jit(lambda p, v: jax_xlstm.mlstm_forward(jcfg, p, v))(
        jax.tree_util.tree_map(lambda a: a[0], jp["mblocks"]["mlstm"]),
        jnp.asarray(x))
    got = xlstm.mlstm_forward(tcfg, tp.mblocks[0].mlstm, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_prefill_step_logits_match_jax(pair):
    """xlstm_forward at S = 300: two mLSTM chunks in every mLSTM block and
    the sLSTM recurrence over all 300 steps.  bf16 against the compiled
    reference (its op-by-op run takes minutes through the sLSTM scan; the
    two differ by 1.9e-2 normwise, the port is within 1.5e-2 of either)."""
    dtype, jm, jp, tm, tp = pair
    toks = _tokens((2, SEQ))
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, SEQ, 256) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_sequential_fill_and_decode_match_jax(pair):
    """The server's fill (decode steps over the prompt), then decode: logits
    at every step and the whole state (mLSTM C, n, m; sLSTM h, c, n, m)
    against the reference's ``decode_fn``."""
    dtype, jm, jp, tm, tp = pair
    b, steps = 2, 4
    toks = _tokens((steps, b), 1)
    jstate = jm.decode_init(b, 8)
    tstate = tm.decode_init(b, 8, device="cpu")
    tdecode = make_decode_step(tm)
    for t in range(steps):
        ln = np.full((b,), t, np.int32)
        jl, jstate = _reference(dtype, jm.decode_fn, jp, jstate,
                                jnp.asarray(toks[t]), jnp.asarray(ln))
        tl, tstate = tdecode(tp, tstate, {
            "tokens": torch.from_numpy(toks[t]),
            "cache_len": torch.from_numpy(ln)})
        _close(tl, jl, dtype)
    for group in jstate:
        for key in jstate[group]:
            _close(tstate[group][key], jstate[group][key], dtype)


def test_sequential_fill_equals_prefill_step():
    """The recurrent decode path and the chunked prefill path compute the
    same logits at every position (float32)."""
    cfg = reduce_config(ARCHS["xlstm-1.3b"], dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 10
    toks = torch.from_numpy(_tokens((b, s), 4))
    full = model.forward(params, {"tokens": toks})
    state = model.decode_init(b, s, device="cpu")
    for t in range(s):
        lt, state = model.decode_fn(params, state, toks[:, t],
                                    torch.full((b,), t, dtype=torch.int32))
        np.testing.assert_allclose(lt.numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_greedy_ids_match_jax_generate_loop():
    """The reference launcher's loop (no prefill_fn, so the sequential fill)
    against the port's server code: identical token ids, in float32."""
    _, jm, jp, tm, tp = _build_pair("float32")
    b, plen, gen = 2, 6, 5
    prompts = _tokens((b, plen), 3)
    decode = jax.jit(jm.decode_fn)
    state = jm.decode_init(b, plen + gen + 8)
    for t in range(plen):
        logits, state = decode(jp, state, jnp.asarray(prompts[:, t]),
                               jnp.full((b,), t, jnp.int32))
    cur = jnp.argmax(logits[:, :256], axis=-1).astype(jnp.int32)
    want = []
    for i in range(gen):
        want.append(np.asarray(cur))
        logits, state = decode(jp, state, cur,
                               jnp.full((b,), plen + i, jnp.int32))
        cur = jnp.argmax(logits[:, :256], axis=-1).astype(jnp.int32)
    got = serve.generate(tm, tp, torch.from_numpy(prompts), gen)
    assert got.mode == "sequential"
    np.testing.assert_array_equal(got.tokens.numpy(), np.stack(want, 1))


def test_generate_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "generate", "--arch", "xlstm-1.3b", "--test-mesh",
        "--device", "cpu", "--requests", "2", "--prompt-len", "4",
        "--gen-tokens", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill (sequential)" in out and "tok/s" in out
    assert "generated token ids (first request):" in out
