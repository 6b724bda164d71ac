"""Port parity for training: the loss, every gradient, the two kernels'
backwards and the train step, against the JAX package.

Reduced llama3.2-3b and granite-moe-1b-a400m (2 layers, d 64) at S = 48 >
``block_q`` = 32, so every attention layer takes the flash path (the
reference's Pallas kernel in interpret mode, the port's plain twin), with
the reference's parameters carried across by ``convert.params_from_numpy(
..., trainable=True)``.  The reference's MLP computes the fused SwiGLU
kernel's function (``swiglu_ref``; ``_KernelFFN`` for the experts), as in
``tests/test_torch_model.py`` and ``tests/test_torch_moe.py``.  The
reference runs with ``remat`` off (its offload policy does not lower on
the CPU); the port runs with it on and off, which computes the same
function (``tests/test_torch_remat.py``).

Tolerances: float32 elementwise 1e-4 (rtol and atol); bfloat16 normwise,
the largest error within 2e-2 of the largest value, the reference run op
by op.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.fused_swiglu.ref import swiglu_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 lm_leaf_paths, params_from_numpy)
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.kernels.fused_swiglu import kernel as K  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as torch_transformer  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

torch.set_num_threads(1)

ARCH_NAMES = ["llama3.2-3b", "granite-moe-1b-a400m"]
OVERRIDES = dict(n_layers=2, attention_impl="pallas", block_q=32,
                 block_kv=32)
B, S = 2, 48


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 2e-2, f"max error {err:.3g} of the largest value"


def _kernel_swiglu(params, x, compute_dtype=jnp.bfloat16, *, skip=False):
    """The reference's ``layers.swiglu`` computing the kernel's function."""
    dt = compute_dtype
    h = swiglu_ref(x.astype(dt).reshape(-1, x.shape[-1]),
                   params["gate"]["kernel"].astype(dt),
                   params["up"]["kernel"].astype(dt))
    return jax_layers.dense(params["down"], h.reshape(*x.shape[:-1], -1), dt)


class _KernelFFN:
    """``jax.numpy`` as the reference's ``models/moe.py`` sees it, with the
    expert FFN's gate and up einsums in fp32 and the hidden rounded once
    before the down einsum: the fused SwiGLU kernel's function."""

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


@pytest.fixture(scope="module", autouse=True)
def reference_mlp_is_the_kernels_function():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "swiglu", _kernel_swiglu)
        mp.setattr(jax_moe, "jnp", _KernelFFN())
        yield


def _reference(dtype, fn, *args):
    """Compiled in float32, op by op in bf16."""
    if dtype == "float32":
        return jax.jit(fn)(*args)
    with jax.disable_jit():
        return fn(*args)


def _pair(arch, dtype, **kw):
    """(port cfg, port model, reference model, reference numpy params)."""
    over = dict(OVERRIDES, dtype=dtype, **kw)
    jcfg = jax_reduce(JAX_ARCHS[arch], **over)
    tcfg = reduce_config(ARCHS[arch], **over)
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return tcfg, build_model(tcfg), jm, jp


def _batch(vocab, seed=0, b=B):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, S + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_leaf(tree, path, i):
    for k in path:
        tree = tree[k]
    return tree if i is None else tree[i]


def _check_tree(cfg, port_named, ref_tree, dtype):
    """Every port leaf (by name) against the reference's leaf."""
    names = set(port_named)
    for name, path, i in lm_leaf_paths(cfg, ref_tree):
        names.discard(name)
        try:
            _close(port_named[name], _ref_leaf(ref_tree, path, i), dtype)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
    assert not names, f"port leaves without a reference leaf: {names}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_every_grad_match_jax(arch, dtype):
    """``Model.loss_fn`` and every gradient (granite's MoE auxiliary loss
    included) against ``jax.value_and_grad`` of the reference's
    ``loss_fn``."""
    tcfg, tm, jm, jp = _pair(arch, dtype)
    batch = _batch(tcfg.vocab)
    want_loss, want_grads = _reference(
        dtype, jax.value_and_grad(jm.loss_fn), jp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jp, tcfg, "cpu", trainable=True)
    loss = tm.loss_fn(params, _torch_batch(batch))
    loss.backward()
    _close(loss, want_loss, "float32")
    _check_tree(tcfg, {n: p.grad for n, p in params.named_parameters()},
                jax.tree_util.tree_map(np.asarray, want_grads), dtype)


def test_moe_aux_loss_is_carried():
    """granite's loss is the cross-entropy plus 0.01 x the summed
    auxiliary loss, as the reference's ``lm_loss``; serving drops it."""
    from repro_torch.models import transformer
    tcfg, tm, jm, jp = _pair("granite-moe-1b-a400m", "float32")
    params = params_from_numpy(jp, tcfg, "cpu", trainable=True)
    batch = _torch_batch(_batch(tcfg.vocab))
    with torch.no_grad():
        logits, aux = transformer.lm_forward_aux(tcfg, params,
                                                 batch["tokens"])
        xent = transformer.softmax_xent(tcfg, logits, batch["targets"])
        loss = tm.loss_fn(params, batch)
        served = tm.forward(params, batch)
    assert aux.item() > 0
    assert torch.equal(served, logits)
    torch.testing.assert_close(loss, xent + 0.01 * aux, rtol=0, atol=0)


def _flash_inputs(dtype, seed=0, hq=4, hkv=2, d=32, sq=S, skv=S):
    rng = np.random.default_rng(seed)
    shapes = [(B, sq, hq, d), (B, skv, hkv, d), (B, skv, hkv, d),
              (B, sq, hq, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (causal, Sq, Skv): self-attention both ways at S = 48, and
# cross-attention (non-causal) of 100 queries against 72 keys, ragged
# against the 32-row blocks; causal attention only at Sq == Skv (the
# kernel's mask is top-left, the reference's oracle's bottom-right)
FLASH_GRAD_CASES = {"True": (True, S, S), "False": (False, S, S),
                    "cross-100x72": (False, 100, 72)}


@pytest.mark.parametrize("case", list(FLASH_GRAD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_grads_match_jax_vjp(dtype, case):
    """dq, dk, dv of the port's flash wrapper (GQA, 2 groups) against
    ``jax.vjp`` of the reference's ``flash_attention`` (the Pallas kernel
    in interpret mode forward, the blockwise recompute backward)."""
    causal, sq, skv = FLASH_GRAD_CASES[case]
    q, k, v, do = _flash_inputs(dtype, sq=sq, skv=skv)
    jdt = getattr(jnp, dtype)
    fn = lambda q, k, v: jax_flash(q, k, v, causal=causal, block_q=32,
                                   block_kv=32)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    out, vjp = jax.vjp(fn, *jargs)
    want = vjp(jnp.asarray(do, jdt))
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
             for a in (q, k, v)]
    got_out = flash_attention(*targs, causal=causal, block_q=32, block_kv=32)
    got = torch.autograd.grad(got_out, targs,
                              torch.from_numpy(do).to(got_out.dtype))
    _close(got_out, out, dtype)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == targs[0].dtype, name
        assert g.shape == w.shape, name
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_grads_match_jax(dtype):
    """The port's MLP (fused SwiGLU gate/up, its backward through the plain
    twin) against ``jax.grad`` of the reference's op-by-op
    ``layers.swiglu``, for x and the three weights."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    w = {n: (rng.standard_normal(s) / 8).astype(np.float32)
         for n, s in (("gate", (64, 96)), ("up", (64, 96)),
                      ("down", (96, 64)))}
    dy = rng.standard_normal((B, S, 64)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = {n: {"kernel": jnp.asarray(a)} for n, a in w.items()}

    def ref(p, x):
        # the op-by-op jnp MLP (``layers.swiglu`` is patched in this module)
        g = jax_layers.dense(p["gate"], x, jdt)
        u = jax_layers.dense(p["up"], x, jdt)
        return jax_layers.dense(p["down"], jax.nn.silu(g) * u, jdt)

    with jax.disable_jit():
        y, vjp = jax.vjp(ref, jparams, jnp.asarray(x, jdt))
        dp, dx = vjp(jnp.asarray(dy, jdt))
    tw = {n: torch.from_numpy(a).requires_grad_() for n, a in w.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    got_y = layers.swiglu(tw, tx, tdt)
    grads = torch.autograd.grad(got_y, [tx] + list(tw.values()),
                                torch.from_numpy(dy).to(tdt))
    _close(got_y, y, dtype)
    _close(grads[0], dx, dtype)
    for g, n in zip(grads[1:], tw):
        _close(g, dp[n]["kernel"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_batched_swiglu_grads_match_jax(dtype):
    """The (E, M, K) expert form, one launch for every expert, against
    ``jax.grad`` of the reference's expert einsums (gate and up in the
    compute dtype, silu * up)."""
    rng = np.random.default_rng(2)
    e, m, kk, f = 3, 40, 32, 48
    x = rng.standard_normal((e, m, kk)).astype(np.float32)
    wg = (rng.standard_normal((e, kk, f)) / 6).astype(np.float32)
    wu = (rng.standard_normal((e, kk, f)) / 6).astype(np.float32)
    dh = rng.standard_normal((e, m, f)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def ref(x, wg, wu):
        g = jnp.einsum("emk,ekf->emf", x, wg)
        u = jnp.einsum("emk,ekf->emf", x, wu)
        return jax.nn.silu(g) * u

    with jax.disable_jit():
        h, vjp = jax.vjp(ref, *[jnp.asarray(a, jdt) for a in (x, wg, wu)])
        want = vjp(jnp.asarray(dh, jdt))
    ins = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, wg, wu)]
    got_h = K.fused_swiglu(*ins)
    got = torch.autograd.grad(got_h, ins, torch.from_numpy(dh).to(tdt))
    _close(got_h, h, dtype)
    for g, w in zip(got, want):
        _close(g, w, dtype)


def _reference_steps(jm, jopt, jp, jstate, batches, microbatches, dtype):
    """The reference step on one CPU device: ``jax.value_and_grad`` of
    ``loss_fn`` (summed over micro-batches, then divided), the fp32 grad
    norm, ``optimizer.update``."""

    def step(params, state, batch):
        if microbatches > 1:
            chunks = [jax.tree_util.tree_map(
                lambda a: a.reshape((microbatches, -1) + a.shape[1:])[i],
                batch) for i in range(microbatches)]
        else:
            chunks = [batch]
        gsum = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
        lsum = 0.0
        for c in chunks:
            loss, g = jax.value_and_grad(jm.loss_fn)(params, c)
            gsum = jax.tree_util.tree_map(jnp.add, gsum, g)
            lsum = lsum + loss
        grads = jax.tree_util.tree_map(lambda g: g / microbatches, gsum)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree_util.tree_leaves(grads)))
        new_p, new_s = jopt.update(grads, state, params)
        return new_p, new_s, lsum / microbatches, gnorm, grads

    fn = jax.jit(step) if dtype == "float32" else step
    out = []
    params, state = jp, jstate
    for batch in batches:
        with (jax.disable_jit() if dtype != "float32"
              else contextlib.nullcontext()):
            params, state, loss, gnorm, grads = fn(
                params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(loss), float(gnorm),
                    jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, grads)))
    return out


def _check_adam_params(cfg, port_named, ref_params, ref_grads, lr, steps):
    """fp32 parameters after ``steps`` AdamW steps, elementwise 1e-4.

    Adam moves an element by about lr * g / (|g| + eps): where the
    reference's gradient was below 1e-6 (and not 0: an embedding row no
    token reads) at some step the normalisation is
    ill-conditioned (a difference in g far inside the grads' own 1e-4
    gate turns the step), so those elements are held to the 2 * lr a
    step that bounds any Adam update instead."""
    for name, path, i in lm_leaf_paths(cfg, ref_params):
        got = _np(port_named[name])
        want = _ref_leaf(ref_params, path, i)
        tiny = np.zeros(want.shape, bool)
        for g in ref_grads:
            g = _ref_leaf(g, path, i)
            tiny |= (np.abs(g) < 1e-6) & (g != 0)
        assert tiny.mean() < 0.05, f"{name}: {tiny.mean():.1%} tiny grads"
        err = np.abs(got - want)
        bound = np.where(tiny, 2 * lr * steps, 1e-4 + 1e-4 * np.abs(want))
        assert (err <= bound).all(), \
            f"{name}: {(err > bound).sum()} elements, max {err.max():.3g}"


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch,dtype", [("llama3.2-3b", "float32"),
                                        ("granite-moe-1b-a400m", "float32"),
                                        ("llama3.2-3b", "bfloat16")])
def test_train_step_matches_reference(arch, dtype, microbatches):
    """``make_train_step`` with AdamW for 3 steps from the reference's
    params and its converted initial state: the loss and ``grad_norm`` of
    each step, and in fp32 every parameter after steps 1 and 3, against
    the reference's value_and_grad + update.  The port runs remat on (the
    default plan) where the reference runs it off.  bf16 parameters are
    not compared: Adam normalises every gradient element, and bf16's ~1%
    gradient differences turn the steps of near-zero elements by up to
    2 * lr, so each step's loss and gradient norm carry the comparison."""
    lr = 1e-3
    tcfg, tm, jm, jp = _pair(arch, dtype, remat=True)
    jopt = jax_make_optimizer("adamw", lr=lr)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, jp))
    batches = [_batch(tcfg.vocab, seed=s, b=4) for s in range(3)]
    ref_cfg = dataclasses.replace(jm.cfg, remat=False)
    want = _reference_steps(jax_build(ref_cfg), jopt, jp, jstate, batches,
                            microbatches, dtype)

    params = params_from_numpy(jp, tcfg, "cpu", trainable=True)
    state = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    bundle = make_train_step(tm, make_optimizer("adamw", lr=lr),
                             ShapeConfig("t", S, 4, "train"),
                             microbatches=microbatches)
    assert bundle.memory_plan.batch_tokens == 4 // microbatches * S
    # the plan reported is the one whose policy the blocks run under
    assert bundle.memory_plan is torch_transformer.memory_plan(
        tcfg, 4 // microbatches * S)
    for i, batch in enumerate(batches):
        params, state, metrics = bundle.fn(params, state,
                                           _torch_batch(batch))
        wloss, wnorm, wparams, _ = want[i]
        np.testing.assert_allclose(float(metrics["loss"]), wloss,
                                   rtol=1e-4 if dtype == "float32" else 2e-2)
        np.testing.assert_allclose(float(metrics["grad_norm"]), wnorm,
                                   rtol=1e-4 if dtype == "float32" else 2e-2)
        if i in (0, 2) and dtype == "float32":
            _check_adam_params(tcfg, dict(params.named_parameters()),
                               wparams, [w[3] for w in want[:i + 1]], lr,
                               i + 1)
    assert int(state["count"]) == 3


def test_grad_norm_is_the_fp32_norm_of_all_grads():
    tcfg, tm, jm, jp = _pair("llama3.2-3b", "float32")
    params = params_from_numpy(jp, tcfg, "cpu", trainable=True)
    opt = make_optimizer("adamw", lr=0.0, weight_decay=0.0)
    state = opt.init(dict(params.named_parameters()))
    bundle = make_train_step(tm, opt, ShapeConfig("t", S, B, "train"))
    batch = _torch_batch(_batch(tcfg.vocab))
    _, _, metrics = bundle.fn(params, state, batch)
    grads = [p.grad.double() for p in params.parameters()]
    want = torch.sqrt(sum((g * g).sum() for g in grads))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(want),
                               rtol=1e-6)


def test_unported_families_refuse_to_train():
    """The hybrid and ssm families, once refused here, now train: a
    trainable init holds every parameter in float32 with gradients, and
    ``loss_fn`` backpropagates into each of them
    (``tests/test_torch_train_recurrent.py`` holds the values to the
    reference)."""
    for arch in ("zamba2-7b", "xlstm-1.3b"):
        model = build_model(reduce_config(ARCHS[arch]))
        params = model.init(0, device="cpu", trainable=True)
        named = dict(params.named_parameters())
        assert all(p.dtype == torch.float32 and p.requires_grad
                   for p in named.values())
        batch = _torch_batch(_batch(256))
        model.loss_fn(params, batch).backward()
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in named.values())
