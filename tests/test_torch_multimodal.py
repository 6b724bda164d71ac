"""Port parity for the multimodal families end to end: a reduced
whisper-tiny (audio: 2 encoder and 4 decoder layers) and a reduced
llama-3.2-vision-11b (vlm: 2 super-blocks of one self block and one cross
block, GQA 4/2), with the reference's parameters carried across by
``repro_torch.convert``, through cross-attention (Sq 100 against Skv 72)
and no-rope attention, the encoder, the prefill step, the loss value,
decode steps and the server's ``generate``.

Every attention reaches the flash path and is ragged against its 64-row
tiles: ``block_q = block_kv = 64``, 100 encoder frames, 72 image tokens,
and a decoder sequence of 100.  ``xgate`` starts at 0 in the reference's
init (tanh(0) = 0, so the cross path would add nothing and a wrong
cross-attention would pass), so every tree here has it set to non-zero
values first.  The reference never writes the decode states' ``xk``/``xv``
(``*_decode_init`` gives zeros), so the decode tests write the same
random values into both states.

The port's MLP computes its gate/up half as the fused SwiGLU kernel does,
so the reference's MLP runs through its ``swiglu_ref`` for the length of
this module (as in tests/test_torch_model.py).

float32 is held elementwise at 1e-4 against the compiled reference.
bfloat16 is held normwise (``max|a-b| / max|b| <= 2e-2``) against the
reference run op by op (``jax.disable_jit``), which rounds per op as the
port does; compiled XLA keeps fused bf16 intermediates in f32.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.kernels.fused_swiglu.ref import swiglu_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import multimodal as jax_mm  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, multimodal  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)

torch.set_num_threads(1)

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
OVERRIDES = {
    VLM: dict(attention_impl="pallas", block_q=64, block_kv=64,
              image_tokens=72, n_kv_heads=2),
    AUDIO: dict(attention_impl="pallas", block_q=64, block_kv=64,
                encoder_seq=100),
}
SEQ = 100
CROSS = {VLM: "cross_blocks", AUDIO: "dec_blocks"}
EXTRA = {VLM: "image_embeds", AUDIO: "enc_frames"}


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
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
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


def _configs(arch, dtype):
    return (jax_reduce(JAX_ARCHS[arch], dtype=dtype, **OVERRIDES[arch]),
            reduce_config(ARCHS[arch], dtype=dtype, **OVERRIDES[arch]))


@functools.lru_cache(maxsize=None)
def _build_pair(arch, dtype):
    """(arch, dtype, jax model, jax params, port model, port params), the
    cross blocks' ``xgate`` set to 0.5, 0.8, ... in both."""
    jcfg, tcfg = _configs(arch, dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    n = jp[CROSS[arch]]["xgate"].shape[0]
    jp[CROSS[arch]]["xgate"] = jnp.asarray(0.5 + 0.3 * np.arange(n),
                                           jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return arch, dtype, jm, jp, build_model(tcfg), \
        params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module", params=[
    (VLM, "float32"), (VLM, "bfloat16"), (AUDIO, "float32"),
    (AUDIO, "bfloat16")], ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    return _build_pair(*request.param)


def _inputs(arch, cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, SEQ), np.int32)
    t = cfg.image_tokens if arch == VLM else cfg.encoder_seq
    extra = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    return toks, extra


def _batches(arch, cfg, b, seed=0, targets=False):
    toks, extra = _inputs(arch, cfg, b, seed)
    jb = {"tokens": jnp.asarray(toks), EXTRA[arch]: jnp.asarray(extra)}
    tb = {"tokens": torch.from_numpy(toks),
          EXTRA[arch]: torch.from_numpy(extra)}
    if targets:
        tgt = np.roll(toks, -1, axis=1)
        jb["targets"] = jnp.asarray(tgt)
        tb["targets"] = torch.from_numpy(tgt)
    return jb, tb


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_build_model_serves_the_family(arch):
    cfg = reduce_config(ARCHS[arch])
    model = build_model(cfg)
    assert model.prefill_fn is None      # cross-attentive: sequential fill
    params = model.init(0, device="cpu")
    cls = multimodal.VisionLM if arch == VLM else multimodal.EncDecLM
    assert isinstance(params, cls)
    cross = params.cross_blocks if arch == VLM else params.dec_blocks
    assert all(p.cross and p.xgate.dtype == torch.float32
               and float(p.xgate) == 0.0 for p in cross)
    if arch == VLM:
        assert multimodal.vlm_layout(cfg) == (2, 1)
        assert multimodal.vlm_layout(ARCHS[VLM]) == (8, 4)
        assert not any(p.cross for p in params.self_blocks)
    else:
        assert len(params.enc_blocks) == cfg.encoder_layers == 2
        assert not any(p.cross for p in params.enc_blocks)


def test_convert_carries_every_parameter(pair):
    arch, dtype, _, jp, _, tp = pair
    n_ref = sum(a.size for a in jax.tree_util.tree_leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    dt = getattr(torch, dtype)
    cross = getattr(tp, CROSS[arch])
    stack = jp[CROSS[arch]]
    for i, blk in enumerate(cross):
        np.testing.assert_array_equal(
            _np(blk.xattn["wk"]),
            np.asarray(stack["xattn"]["wk"]["kernel"][i].astype(dtype),
                       np.float32))
        assert blk.xgate.dtype == torch.float32
        assert float(blk.xgate) == pytest.approx(0.5 + 0.3 * i)
        assert blk.ln_x.dtype == torch.float32
        assert blk.xattn["wo"].dtype == dt and blk.mlp["down"].dtype == dt
    assert not any(p.requires_grad for p in tp.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["cross", "no_rope"])
def test_attention_matches_jax(mode, dtype):
    """``attention_forward`` through the flash path at Sq 100: cross
    (K, V from 72 image rows, GQA 4/2, non-causal) and self-attention
    without rope (causal)."""
    jcfg, tcfg = _configs(VLM, dtype)
    rng = np.random.default_rng(7)
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)),
                      ("wo", (64, 64)))}
    x = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    img = rng.standard_normal((2, 72, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ)[None], (2, SEQ))
    kw = dict(kv_x=img, causal=False, use_rope=False) if mode == "cross" \
        else dict(use_rope=False)
    jdt = jnp.dtype(dtype)

    def ref(p, x, kv_x=None):
        return jax_attn.attention_forward(
            jcfg, p, x, positions=jnp.asarray(pos), **{**kw, "kv_x": kv_x})

    jw = {n: {"kernel": jnp.asarray(a)} for n, a in w.items()}
    jkv = None if mode != "cross" else jnp.asarray(img).astype(jdt)
    want = _reference(dtype, ref, jw, jnp.asarray(x).astype(jdt), jkv)
    tdt = getattr(torch, dtype)
    tkw = dict(kw)
    if mode == "cross":
        tkw["kv_x"] = torch.from_numpy(img).to(tdt)
    got = attention.attention_forward(
        tcfg, {n: torch.from_numpy(a).to(tdt) for n, a in w.items()},
        torch.from_numpy(x).to(tdt), positions=torch.from_numpy(pos.copy()),
        **tkw)
    assert got.shape == (2, SEQ, 64) and got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    arch, dtype, jm, jp, tm, tp = _build_pair(AUDIO, dtype)
    _, frames = _inputs(arch, tm.cfg, 2)
    want = _reference(dtype, lambda p, f: jax_mm.encdec_encode(jm.cfg, p, f),
                      jp, jnp.asarray(frames))
    with torch.no_grad():
        got = multimodal.encdec_encode(tm.cfg, tp, torch.from_numpy(frames))
    assert got.shape == (2, 100, 64)
    _close(got, want, dtype)


def test_prefill_step_logits_match_jax(pair):
    """The whole forward at S = 100: every self, encoder and cross
    attention through the flash path."""
    arch, dtype, jm, jp, tm, tp = pair
    jb, tb = _batches(arch, tm.cfg, 2)
    want = _reference(dtype, jm.forward, jp, jb)
    got = make_prefill_step(tm)(tp, tb)
    assert got.shape == (2, SEQ, 256) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_cross_path_reaches_the_logits(pair):
    """With ``xgate`` non-zero a second image / frame input moves the
    logits; with every ``xgate`` at 0 (the reference's init) it does not."""
    arch, dtype, _, _, tm, tp = pair
    _, tb = _batches(arch, tm.cfg, 1)
    step = make_prefill_step(tm)
    a = step(tp, tb)
    other = dict(tb, **{EXTRA[arch]: tb[EXTRA[arch]] + 1.0})
    assert (step(tp, other) - a).abs().max() > 1e-3
    gates = [p.xgate for p in getattr(tp, CROSS[arch])]
    saved = [g.detach().clone() for g in gates]
    try:
        for g in gates:
            g.data.zero_()
        assert torch.equal(step(tp, tb), step(tp, other))
    finally:
        for g, s in zip(gates, saved):
            g.data.copy_(s)


def test_loss_matches_jax(pair):
    arch, dtype, jm, jp, tm, tp = pair
    jb, tb = _batches(arch, tm.cfg, 2, seed=3, targets=True)
    want = _reference(dtype, jm.loss_fn, jp, jb)
    with torch.no_grad():
        got = tm.loss_fn(tp, tb)
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want, dtype)


def test_decode_steps_match_jax(pair):
    """3 decode steps against the reference's ``decode_fn``, the same random
    ``xk``/``xv`` written into both states: the logits at every step and
    every self-attention cache after."""
    arch, dtype, jm, jp, tm, tp = pair
    b, steps, max_seq = 2, 3, 8
    jstate = jm.decode_init(b, max_seq)
    tstate = tm.decode_init(b, max_seq, device="cpu")
    assert set(tstate) == set(jstate)
    rng = np.random.default_rng(11)
    for key in ("xk", "xv"):
        assert tuple(tstate[key].shape) == jstate[key].shape
        val = rng.standard_normal(jstate[key].shape).astype(np.float32)
        jstate[key] = jnp.asarray(val).astype(jstate[key].dtype)
        tstate[key].copy_(torch.from_numpy(val))
    toks = rng.integers(0, 256, (steps, b), np.int32)
    tdecode = make_decode_step(tm)
    for t in range(steps):
        ln = np.full((b,), t, np.int32)
        jl, jstate = _reference(dtype, jm.decode_fn, jp, jstate,
                                jnp.asarray(toks[t]), jnp.asarray(ln))
        tl, tstate = tdecode(tp, tstate, {
            "tokens": torch.from_numpy(toks[t]),
            "cache_len": torch.from_numpy(ln)})
        assert tl.shape == (b, 256)
        _close(tl, jl, dtype)
    for key in jstate:
        _close(tstate[key], jstate[key], dtype)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_generate_cli_on_cpu(arch, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "generate", "--arch", arch, "--test-mesh", "--device", "cpu",
        "--requests", "2", "--prompt-len", "4", "--gen-tokens", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "prefill (sequential)" in out and "tok/s" in out
    assert "generated token ids (first request):" in out
