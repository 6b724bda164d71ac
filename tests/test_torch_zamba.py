"""Port parity for the hybrid LM end to end: a reduced zamba2-7b (5 layers,
the shared attention block every 2, so 2 groups and a tail of 1) with the
reference's parameters carried across by ``repro_torch.convert``, through
one mamba layer, the prefill step (S = 300: two SSD chunks and the flash
path of the shared block), the sequential state fill and decode, and the
greedy server loop.

float32 is held elementwise at 1e-4 against the compiled reference.
bfloat16 is held normwise (``max|a-b| / max|b| <= 2e-2``) against the
reference run op by op (``jax.disable_jit``): compiled XLA keeps fused bf16
intermediates in f32 (ROADMAP queue C), and through the mamba layers the
compiled reference differs from its own op-by-op run by ~3e-2 normwise,
more than the tolerance; the port rounds per op, as the op-by-op run does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm, zamba  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)

torch.set_num_threads(1)

OVERRIDES = dict(attention_impl="pallas", block_q=64, block_kv=64)
SEQ = 300          # > block_q: the flash path; > 256: two SSD chunks


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
    jcfg = jax_reduce(JAX_ARCHS["zamba2-7b"], dtype=dtype, **OVERRIDES)
    tcfg = reduce_config(ARCHS["zamba2-7b"], dtype=dtype, **OVERRIDES)
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


def test_reduced_config_layout():
    cfg = reduce_config(ARCHS["zamba2-7b"])
    assert zamba.layout(cfg) == (2, 1)
    assert zamba.layout(ARCHS["zamba2-7b"]) == (13, 3)
    model = build_model(cfg)
    assert model.prefill_fn is None      # recurrent state: sequential fill


def test_convert_carries_every_parameter(pair):
    dtype, _, jp, tm, tp = pair
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    assert len(tp.mblocks) == 4 and len(tp.tail) == 1
    dt = getattr(torch, dtype)
    for i, layer in enumerate(list(tp.mblocks) + list(tp.tail)):
        stack, j = (jp["mblocks"], i) if i < 4 else (jp["tail"], i - 4)
        np.testing.assert_array_equal(
            _np(layer.ssm["in_proj"]),
            np.asarray(stack["ssm"]["in_proj"]["kernel"][j].astype(dtype),
                       np.float32))
        np.testing.assert_array_equal(_np(layer.ssm["conv"]),
                                      np.asarray(stack["ssm"]["conv"][j]))
        assert layer.ssm["out_proj"].dtype == dt
        for name in ("conv", "A_log", "D", "dt_bias", "norm"):
            assert layer.ssm[name].dtype == torch.float32
        assert layer.ln.dtype == torch.float32
    np.testing.assert_array_equal(
        _np(tp.shared.attn["wq"]),
        np.asarray(jp["shared"]["attn"]["wq"]["kernel"].astype(dtype),
                   np.float32))
    assert tp.shared.mlp["down"].dtype == dt and tp.embed.dtype == dt
    assert not any(p.requires_grad for p in tp.parameters())


def test_shared_block_is_one_parameter_set(pair, monkeypatch):
    """Mode E: every application of the shared block runs the one Block
    and reads the same storage."""
    _, _, _, tm, tp = pair
    blocks = [m for m in tp.modules() if isinstance(m, zamba.Block)]
    assert blocks == [tp.shared]
    seen = []
    real = zamba.block_forward

    def spy(cfg, p, x, positions):
        seen.append((id(p), p.attn["wq"].data_ptr(),
                     p.mlp["gate"].data_ptr()))
        return real(cfg, p, x, positions)

    monkeypatch.setattr(zamba, "block_forward", spy)
    tm.forward(tp, {"tokens": torch.from_numpy(_tokens((1, 8)))})
    assert len(seen) == 2 and len(set(seen)) == 1
    assert seen[0][0] == id(tp.shared)


def test_ssm_layer_matches_jax(pair):
    """One mamba layer: ``ssm_forward`` at S = 300 (two chunks, ragged) and
    a few ``ssm_decode_step``s, state included."""
    dtype, jm, jp, tm, tp = pair
    jcfg, tcfg = jm.cfg, tm.cfg
    jparams = jax.tree_util.tree_map(lambda a: a[1], jp["mblocks"]["ssm"])
    tparams = tp.mblocks[1].ssm
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = _reference(dtype, lambda p, v: jax_ssm.ssm_forward(jcfg, p, v),
                      jparams, jx)
    got = ssm.ssm_forward(tcfg, tparams,
                          torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.shape == (2, SEQ, 64)
    _close(got, want, dtype)

    jh = jax_ssm.init_ssm_state(jcfg, 2, 1)
    th = ssm.init_ssm_state(tcfg, 2, 1, device="cpu")
    jst, jconv = jh["h"][0], jh["conv"][0]
    tst, tconv = th["h"][0], th["conv"][0]
    for t in range(4):
        xt = x[:, t:t + 1]
        jy, jst, jconv = _reference(
            dtype, lambda p, v, s, c: jax_ssm.ssm_decode_step(jcfg, p, v, s, c),
            jparams, jnp.asarray(xt).astype(dtype), jst, jconv)
        ty, tst, tconv = ssm.ssm_decode_step(
            tcfg, tparams, torch.from_numpy(xt).to(getattr(torch, dtype)),
            tst, tconv)
        _close(ty, jy, dtype)
    _close(tst, jst, dtype)
    _close(tconv, jconv, dtype)


def test_mixer_skip_is_not_ported():
    """``mixer_skip``, the reference's cost-probe mode, is ported: the mamba
    layer bypasses the SSD scan (y = x in float32) as the reference's does,
    and the outputs agree in fp32."""
    jcfg = jax_reduce(JAX_ARCHS["zamba2-7b"], mixer_skip=True,
                      dtype="float32")
    tcfg = reduce_config(ARCHS["zamba2-7b"], mixer_skip=True, dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    x = np.random.default_rng(6).standard_normal((2, 40, 64)) \
        .astype(np.float32)
    want = jax.jit(lambda p, v: jax_ssm.ssm_forward(jcfg, p, v))(
        jax.tree_util.tree_map(lambda a: a[0], jp["mblocks"]["ssm"]),
        jnp.asarray(x))
    got = ssm.ssm_forward(tcfg, tp.mblocks[0].ssm, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_prefill_step_logits_match_jax(pair):
    """zamba_forward at S = 300: the flash path in both applications of the
    shared block, two SSD chunks in every mamba layer."""
    dtype, jm, jp, tm, tp = pair
    toks = _tokens((2, SEQ))
    want = _reference(dtype, jm.forward, jp, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tm)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, SEQ, 256) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_sequential_fill_and_decode_match_jax(pair):
    """The server's fill (decode steps over the prompt), then decode: logits
    at every step and the whole state (SSM h and conv window, per-group KV
    caches) against the reference's ``decode_fn``."""
    dtype, jm, jp, tm, tp = pair
    b, steps, max_seq = 2, 6, 12
    toks = _tokens((steps, b), 1)
    jstate = jm.decode_init(b, max_seq)
    tstate = tm.decode_init(b, max_seq, device="cpu")
    assert tstate["attn"]["k"].shape[0] == 2           # one per application
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
    cfg = reduce_config(ARCHS["zamba2-7b"], dtype="float32", **OVERRIDES)
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
    """The reference launcher's loop (repro/launch/serve.py run_generate:
    no prefill_fn, so the sequential fill) against the port's server code:
    identical token ids, in float32 since bf16 rounding can flip
    near-tied random-weight logits."""
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
        "serve", "generate", "--arch", "zamba2-7b", "--test-mesh",
        "--device", "cpu", "--requests", "2", "--prompt-len", "4",
        "--gen-tokens", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill (sequential)" in out and "tok/s" in out
    assert "generated token ids (first request):" in out
