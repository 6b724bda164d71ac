"""Port parity for training the multimodal families against the JAX
package: a reduced whisper-tiny (audio: 2 encoder and 4 decoder blocks) and
a reduced llama-3.2-vision-11b (vlm: 2 super-blocks of one self block and
one cross block, GQA 4/2).

The reduced configs are those of ``tests/test_torch_multimodal.py``: every
attention reaches the flash path, ragged against its 64-row tiles
(``block_q = block_kv = 64``, a decoder sequence of 100 against 100
encoder frames or 72 image tokens), with ``remat=True`` on both sides, so
the port's checkpoint regions (one per encoder and decoder block, one per
VLM super-block) face the reference's ``jax.checkpoint`` calls.  The
reference's ``xgate`` starts at 0, where tanh(0) = 0 sends no gradient
into a cross-attention, nor into whisper's encoder (its output reaches the
loss only through cross-attention): every tree here has it set to 0.5,
0.8, ... first, and one test checks those grads are exactly 0 at 0 on
both sides.  The reference's MLP computes the fused SwiGLU kernel's
function (``swiglu_ref``), as in the other parity modules.

Tolerances: float32 elementwise 1e-4 against the compiled reference;
bfloat16 normwise (the largest error within 2e-2 of the largest value)
against the reference run op by op.
"""

import contextlib
import dataclasses
import functools

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
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (_param_shape,  # noqa: E402
                                 adamw_state_from_numpy, lm_leaf_paths,
                                 params_from_numpy)
from repro_torch.core import remat  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_producer  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import multimodal, transformer  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import _dequantize  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
ARCH_NAMES = [VLM, AUDIO]
OVERRIDES = {
    VLM: dict(attention_impl="pallas", block_q=64, block_kv=64,
              image_tokens=72, n_kv_heads=2, remat=True),
    AUDIO: dict(attention_impl="pallas", block_q=64, block_kv=64,
                encoder_seq=100, remat=True),
}
B, SEQ = 2, 100
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
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 2e-2, f"max error {err:.3g} of the largest value"


def _ref_leaf(tree, path, i):
    for k in path:
        tree = tree[k]
    return tree if i is None else tree[i]


def _configs(arch, dtype="float32", **over):
    over = dict(OVERRIDES[arch], dtype=dtype, **over)
    return jax_reduce(JAX_ARCHS[arch], **over), \
        reduce_config(ARCHS[arch], **over)


def _batch(arch, cfg, b=B, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, SEQ + 1)).astype(np.int32)
    t = cfg.image_tokens if arch == VLM else cfg.encoder_seq
    extra = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            EXTRA[arch]: extra}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _tree(arch, gate=True):
    """The reference's numpy params, the cross blocks' ``xgate`` set to
    0.5, 0.8, ... (``gate``) or left at the init's 0."""
    jcfg, _ = _configs(arch)
    jp = jax.tree_util.tree_map(np.asarray,
                                jax_build(jcfg).init(jax.random.PRNGKey(0)))
    if gate:
        n = jp[CROSS[arch]]["xgate"].shape[0]
        jp[CROSS[arch]]["xgate"] = (0.5 + 0.3 * np.arange(n)) \
            .astype(np.float32)
    return jp


@functools.lru_cache(maxsize=None)
def _value_and_grad(arch, dtype):
    """The reference's ``jax.value_and_grad(loss_fn)``: compiled in
    float32, run op by op in bf16."""
    jcfg, _ = _configs(arch, dtype)
    fn = jax.value_and_grad(jax_build(jcfg).loss_fn)
    return jax.jit(fn) if dtype == "float32" else fn


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, gate=True):
    """(port cfg, batch, the reference's loss and numpy grads)."""
    _, tcfg = _configs(arch, dtype)
    batch = _batch(arch, tcfg)
    with (jax.disable_jit() if dtype != "float32"
          else contextlib.nullcontext()):
        loss, grads = _value_and_grad(arch, dtype)(_tree(arch, gate),
                                                   _jnp(batch))
    return tcfg, batch, float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_grads(arch, cfg, batch, gate=True):
    """(loss, grads by name, each region's RegionStats) of one backward of
    the port's ``loss_fn`` from the reference's params."""
    params = params_from_numpy(_tree(arch, gate), cfg, "cpu", trainable=True)
    with remat.observe_regions() as stats:
        loss = build_model(cfg).loss_fn(params, _torch(batch))
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in params.named_parameters()}, \
        stats


def _cross_and_encoder(arch, names):
    """The grads no gradient reaches while every xgate is 0: each
    cross-attention's projections and, in whisper, the whole encoder."""
    return [n for n in names if ".xattn." in n
            or (arch == AUDIO and (n.startswith("enc_") or n == "enc_ln"))]


# ---------------------------------------------------------------------------
# leaf paths and the AdamW state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_leaf_paths_name_every_parameter_once(arch):
    """At the published depth (narrow widths), each ``named_parameters()``
    entry once, each path a leaf of the reference's
    tree; at the published widths and depth each path's per-layer shape
    (``convert._param_shape``) is the reference's (``jax.eval_shape``, no
    memory)."""
    full = ARCHS[arch]
    cfg = reduce_config(full, n_layers=full.n_layers,
                        encoder_layers=full.encoder_layers,
                        cross_attn_every=full.cross_attn_every)
    jcfg = jax_reduce(JAX_ARCHS[arch], n_layers=full.n_layers,
                      encoder_layers=full.encoder_layers,
                      cross_attn_every=full.cross_attn_every)
    tree = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    named = [n for n, _ in build_model(cfg).init(
        0, device="cpu", trainable=True).named_parameters()]
    paths = list(lm_leaf_paths(cfg, tree))
    assert sorted(n for n, _, _ in paths) == sorted(named)
    assert len(set(named)) == len(named)
    assert len({p for _, p, _ in paths}) == \
        len(jax.tree_util.tree_leaves(tree))
    n_super, per = multimodal.vlm_layout(cfg) if arch == VLM else (0, 0)
    stacked = {"enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.n_layers,
               "self_blocks": n_super * per, "cross_blocks": n_super}
    for name, path, i in paths:
        leaf = _ref_leaf(tree, path, None)
        if i is None:
            assert path[0] not in stacked, name
        else:
            assert leaf.shape[0] == stacked[path[0]] > i >= 0, name
    abstract = jax.eval_shape(jax_build(JAX_ARCHS[arch]).init,
                              jax.random.PRNGKey(0))
    for name, path, i in lm_leaf_paths(full, abstract):
        shape = _ref_leaf(abstract, path, None).shape
        if i is not None:
            assert tuple(_param_shape(full, path)) == shape[1:], name


def test_leaf_paths_refuse_an_unknown_family():
    """A family without its own branch raises instead of walking another
    family's tree (an unknown one once yielded xLSTM paths)."""
    cfg = dataclasses.replace(reduce_config(ARCHS[AUDIO]), family="speech")
    with pytest.raises(ValueError, match="speech"):
        list(lm_leaf_paths(cfg, {}))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_adamw_state_converts(arch, state_dtype):
    """The reference's AdamW state after one update, converted: every
    moment equal to the reference's layer slice (int8: dequantized; each
    stacked ``xgate`` is one element of a block its layers share).  The
    widths are 256 so that every other stacked leaf splits into whole
    int8 blocks (a layer of 64 elements raises,
    ``tests/test_torch_ckpt.py``)."""
    wide = dict(d_model=256, head_dim=64, d_ff=512)
    jcfg, tcfg = _configs(arch, **wide)
    jopt = jax_make_optimizer("adamw", state_dtype=state_dtype)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_build(jcfg).init(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.sin(jnp.arange(p.size, dtype=jnp.float32)
                          ).reshape(p.shape), params)
    _, jstate = jax.jit(jopt.update)(grads, jopt.init(params), params)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    state = adamw_state_from_numpy(jstate, tcfg, "cpu")
    named = dict(params_from_numpy(tree, tcfg, "cpu",
                                   trainable=True).named_parameters())
    assert set(state["mu"]) == set(named)
    assert int(state["count"]) == 1
    for name, path, i in lm_leaf_paths(tcfg, jstate["mu"]):
        mv = _ref_leaf(jstate["mu"], path, None)
        shape = named[name].shape
        for k in ("m", "v"):
            got = state["mu"][name][k]
            if state_dtype == "int8":
                full = mv[k]
                ref_shape = np.shape(_ref_leaf(tree, path, None))
                want = (np.asarray(full["q"], np.float32) * np.asarray(
                    full["scale"], np.float32)).reshape(-1)
                want = want[:int(np.prod(ref_shape))].reshape(ref_shape)
                got = _dequantize(got, shape)
            else:
                want = mv[k]
                assert got.dtype == getattr(torch, state_dtype), name
            want = want if i is None else want[i]
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_every_grad_match_jax(arch, dtype):
    """``Model.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, remat on both
    sides; the cross-attentions' and whisper's encoder grads non-zero.

    float32: each leaf elementwise.  bfloat16: the whole gradient, every
    leaf flattened into one tensor, normwise: the port's and the
    reference's bf16 grads each lie 2.5-2.7% (Frobenius) from the fp32
    grads, equally far, and single leaves of such noise part by more than
    2e-2 (a cross block's scalar ``xgate`` gradient, a cancelling sum over
    every activation, by up to 6%)."""
    tcfg, batch, want_loss, want = _reference(arch, dtype)
    loss, grads, _ = _port_grads(arch, tcfg, batch)
    _close(loss, want_loss, dtype)
    names = set(grads)
    got_all, want_all = [], []
    for name, path, i in lm_leaf_paths(tcfg, want):
        names.remove(name)
        g, w = grads[name], _ref_leaf(want, path, i)
        assert g is not None and bool(torch.isfinite(g).all()), name
        if dtype == "float32":
            try:
                _close(g, w, dtype)
            except AssertionError as e:
                raise AssertionError(f"{name}: {e}") from None
        got_all.append(_np(g).ravel())
        want_all.append(_np(w).ravel())
    assert not names, f"port leaves without a reference leaf: {names}"
    _close(np.concatenate(got_all), np.concatenate(want_all), dtype)
    reached = _cross_and_encoder(arch, grads)
    assert reached and all(bool(grads[n].abs().max() > 0) for n in reached)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cross_grads_are_zero_at_the_reference_init(arch):
    """With every xgate at the init's 0 no gradient reaches a
    cross-attention's projections, nor whisper's encoder: exactly 0 in the
    port, as in the reference; the gates' own grads are not 0."""
    tcfg, batch, want_loss, want = _reference(arch, "float32", gate=False)
    loss, grads, _ = _port_grads(arch, tcfg, batch, gate=False)
    _close(loss, want_loss, "float32")
    zero = _cross_and_encoder(arch, grads)
    paths = {n: (p, i) for n, p, i in lm_leaf_paths(tcfg, want)}
    for n in zero:
        assert not bool(grads[n].any()), n
        assert not _ref_leaf(want, *paths[n]).any(), n
    gates = [n for n in grads if n.endswith(".xgate")]
    assert gates and all(float(grads[n]) != 0 for n in gates)
    for n in gates:
        _close(grads[n], _ref_leaf(want, *paths[n]), "float32")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_checkpoint_regions(arch):
    """With remat on: one region per VLM super-block (its self blocks and
    its cross block together), one per encoder and per decoder block of
    whisper; each replayed once, keeping the tags the keep-all plan names
    and, in the VLM, every tensor its blocks tag (q and the attention
    output of each self- and cross-attention, each SwiGLU hidden); the
    image or the encoder's output is an input of each cross region."""
    tcfg, batch, _, _ = _reference(arch, "float32")
    _, _, stats = _port_grads(arch, tcfg, batch)
    kept = set(transformer.memory_plan(tcfg, B * SEQ).offload_policy.saved)
    assert all(s.replays == 1 and s.offloaded == {} and set(s.kept) <= kept
               for s in stats)
    x = B * SEQ * tcfg.d_model * 4
    q = B * SEQ * tcfg.n_heads * tcfg.head_dim * 4
    h = B * SEQ * tcfg.d_ff * 4
    if arch == VLM:
        n_super, per = multimodal.vlm_layout(tcfg)
        assert len(stats) == n_super == 2
        img = B * tcfg.image_tokens * tcfg.d_model * 4
        attns = per + 2                  # self blocks, the cross block's two
        want = {"qkv": attns * q, "attn_out": attns * q,
                "mlp_hidden": (per + 1) * h}
        assert all(s.kept == want and s.input_bytes == x + img
                   for s in stats)
    else:
        n_enc = tcfg.encoder_layers
        assert len(stats) == n_enc + tcfg.n_layers == 6
        enc = B * tcfg.encoder_seq * tcfg.d_model * 4
        for j, s in enumerate(stats):
            cross = j >= n_enc
            rows = SEQ if cross else tcfg.encoder_seq
            qq, hh = q * rows // SEQ, h * rows // SEQ
            assert s.kept == {"qkv": qq * (1 + cross),
                              "attn_out": qq * (1 + cross),
                              "mlp_hidden": hh}, j
            assert s.input_bytes == (x + enc if cross else enc), j


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_recomputing_every_tag_gives_the_same_values(arch):
    """The plan decides what is held, not what is computed: with every tag
    recomputed (a zero budget) and with remat off, the loss and every
    gradient equal the keep-all plan's bit for bit."""
    tcfg, batch, _, _ = _reference(arch, "float32")
    loss, grads, _ = _port_grads(arch, tcfg, batch)
    for over in (dict(remat_budget_bytes=0), dict(remat=False)):
        cfg = dataclasses.replace(tcfg, **over)
        other_loss, other, stats = _port_grads(arch, cfg, batch)
        if cfg.remat:
            assert stats and all(s.kept == {} for s in stats)
        else:
            assert not stats
        assert torch.equal(other_loss, loss)
        for n, g in grads.items():
            assert torch.equal(other[n], g), (over, n)


# ---------------------------------------------------------------------------
# the train step, the trainer and the launcher
# ---------------------------------------------------------------------------

def _reference_steps(jm, jopt, jp, jstate, batches):
    """The reference step, compiled: ``jax.value_and_grad`` of
    ``loss_fn``, the fp32 grad norm, ``optimizer.update``."""

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(jm.loss_fn)(params, batch)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                             for g in jax.tree_util.tree_leaves(grads)))
        params, state = jopt.update(grads, state, params)
        return params, state, loss, gnorm, grads

    out, params, state = [], jp, jstate
    for batch in batches:
        params, state, loss, gnorm, grads = step(params, state, _jnp(batch))
        out.append((float(loss), float(gnorm),
                    jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, grads)))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_reference(arch):
    """``make_train_step`` with AdamW for 2 steps from the reference's
    params and its converted initial state: each step's loss and grad
    norm, and every fp32 parameter after each step (elements whose
    reference gradient fell below 1e-6 held to the 2 lr a step that
    bounds any Adam update, as in ``tests/test_torch_train.py``)."""
    lr = 1e-3
    jcfg, tcfg = _configs(arch)
    jp = _tree(arch)
    jopt = jax_make_optimizer("adamw", lr=lr)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, jp))
    batches = [_batch(arch, tcfg, seed=s) for s in (1, 2)]
    want = _reference_steps(jax_build(jcfg), jopt, jp, jstate, batches)
    params = params_from_numpy(jp, tcfg, "cpu", trainable=True)
    state = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    bundle = make_train_step(build_model(tcfg), make_optimizer("adamw",
                                                               lr=lr),
                             ShapeConfig("t", SEQ, B, "train"))
    assert bundle.memory_plan is transformer.memory_plan(tcfg, B * SEQ)
    for step, batch in enumerate(batches):
        params, state, metrics = bundle.fn(params, state, _torch(batch))
        wloss, wnorm, wparams, _ = want[step]
        np.testing.assert_allclose(float(metrics["loss"]), wloss, rtol=1e-4)
        np.testing.assert_allclose(float(metrics["grad_norm"]), wnorm,
                                   rtol=1e-4)
        named = dict(params.named_parameters())
        for name, path, i in lm_leaf_paths(tcfg, wparams):
            got = _np(named[name])
            ref = _ref_leaf(wparams, path, i)
            tiny = np.zeros(np.shape(ref), bool)
            for w in want[:step + 1]:
                g = _ref_leaf(w[3], path, i)
                tiny |= (np.abs(g) < 1e-6) & (g != 0)
            bound = np.where(tiny, 2 * lr * (step + 1),
                             1e-4 + 1e-4 * np.abs(ref))
            err = np.abs(got - ref)
            assert (err <= bound).all(), \
                f"{name}: {(err > bound).sum()} elements, max {err.max():.3g}"
    assert int(state["count"]) == 2


def multimodal_producer(cfg, seq_len):
    """``synthetic_lm_producer``'s tokens plus the stubbed frontend's
    embeddings, (T, d) standard normals drawn from the example's own
    seed, as a caller of ``Trainer(..., producer=...)`` supplies them."""
    tokens = synthetic_lm_producer(cfg.vocab, seq_len)
    key, t = (("image_embeds", cfg.image_tokens) if cfg.family == "vlm"
              else ("enc_frames", cfg.encoder_seq))

    def produce(epoch, index, rng):
        ex = tokens(epoch, index, rng)
        g = np.random.default_rng((epoch * 7919 + index) & 0x7FFFFFFF)
        ex[key] = g.standard_normal((t, cfg.d_model)).astype(np.float32)
        return ex

    return produce


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_trainer_restarts_bit_for_bit(arch, tmp_path):
    """``Trainer`` with a multimodal producer, 2 micro-batches: a 2-step
    run with a checkpoint after step 1, restarted from it for step 2,
    gives the uninterrupted run's losses and parameters bit for bit."""
    _, cfg = _configs(arch, "bfloat16")
    shape = ShapeConfig("t", SEQ, 2, "train")

    def run(steps, ckpt=None):
        trainer = Trainer(build_model(cfg), make_optimizer("adamw"), shape,
                          TrainerConfig(steps=steps, log_every=1,
                                        ckpt_every=1, ckpt_dir=ckpt),
                          producer=multimodal_producer(cfg, SEQ),
                          microbatches=2, device="cpu")
        out = trainer.run()
        return [h["loss"] for h in out["history"]], out["params"]

    straight, p_straight = run(2)
    assert all(np.isfinite(straight))
    assert abs(straight[0] - np.log(cfg.vocab)) < 1.0
    first, _ = run(1, str(tmp_path))
    resumed, p_resumed = run(2, str(tmp_path))
    assert first == straight[:1] and resumed == straight[1:]
    for (n, a), (_, b) in zip(p_straight.named_parameters(),
                              p_resumed.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launch_train_refuses_the_family(arch):
    """``launch.train`` feeds tokens only, as the reference's does (whose
    jitted step then fails on the missing key): the port refuses at once,
    naming the frontend's input and ``Trainer(producer=...)``."""
    with pytest.raises(SystemExit, match=EXTRA[arch]) as e:
        launch_train.main(["--arch", arch, "--test-mesh", "--device", "cpu",
                           "--steps", "1"])
    assert "producer=" in str(e.value)
