"""The sharded train and prefill steps on 4 gloo ranks against the JAX
reference's one-device functions.

Configs: a reduced llama (2 layers, d 64, 4 heads of 16, kv heads 2 and
1, vocab 512), one whose 12 heads in 3 GQA groups do not split into whole
groups per model rank (each local q head indexes its own group), and a
reduced vision LM (one super-block: a self block and a cross block,
``xgate`` 0.5, ``remat=True`` so the super-block is one checkpoint region
whose replay re-issues its collectives).  ``block_q`` 32 against a
sequence of 48 and 40 image tokens puts every attention on the flash path
(the kernel's plain twin on the CPU).  Each runs on the meshes (2, 2),
(4, 1) and (1, 4), with FSDP forced on and off, at 1 and 2 micro-batches:
the fp32 loss and every gradient leaf equal ``jax.value_and_grad(
model.loss_fn)`` to 1e-4 elementwise; the parameters after one AdamW step
equal the one-rank port's where the gradient is at least 1e-6 (Adam's
g / (|g| + eps) turns a 1e-9 difference of a smaller one into a step);
prefill logits equal the reference's forward to 1e-4; in bf16 the loss
and the whole gradient agree normwise to 2e-2 (a cross block's scalar
``xgate`` gradient is a cancelling sum).  All ranks run in one child
process under a hard limit (``tests/torch_dist_util.py``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_leaf_paths, params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)

# the module's ranks start once, in its module fixture: under any xdist
# mode that splits a file (``--dist loadgroup``) its tests stay together
pytestmark = pytest.mark.xdist_group("dist_train")

B, S = 8, 48
LLAMA = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab=512, attention_impl="pallas", block_q=32, block_kv=32)
CONFIGS = {
    "llama_kv2": ("llama3.2-3b", LLAMA),
    "llama_kv1": ("llama3.2-3b", dict(LLAMA, n_kv_heads=1)),
    "llama_h12kv3": ("llama3.2-3b", dict(LLAMA, n_heads=12, n_kv_heads=3)),
    "vlm": ("llama-3.2-vision-11b",
            dict(LLAMA, cross_attn_every=2, image_tokens=40, remat=True)),
}
MESHES = [(2, 2), (4, 1), (1, 4)]
MKEYS = ["x".join(map(str, m)) for m in MESHES]
TRAIN = [(m, c, f, mb) for m in MKEYS for c in CONFIGS
         for f in (False, True) for mb in (1, 2)]
BF16 = {f"{c}_bf16": (CONFIGS[c][0], dict(CONFIGS[c][1], dtype="bfloat16"))
        for c in ("llama_kv2", "vlm")}
LR = 1e-2


def _cfgs(name):
    arch, over = {**CONFIGS, **BF16}[name]
    dtype = over.get("dtype", "float32")
    over = dict(over, dtype=dtype)
    ref = dict(over, attention_impl="naive")
    return arch, over, jax_reduce(JAX_ARCHS[arch], **ref)


@functools.lru_cache(maxsize=None)
def _tree(name):
    arch, _, jcfg = _cfgs(name)
    jp = jax.tree_util.tree_map(np.asarray,
                                jax_build(jcfg).init(jax.random.PRNGKey(0)))
    if "cross_blocks" in jp:
        jp["cross_blocks"]["xgate"] = np.full_like(
            jp["cross_blocks"]["xgate"], 0.5)
    return jp


@functools.lru_cache(maxsize=None)
def _batch(name):
    arch, over, jcfg = _cfgs(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if jcfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, jcfg.image_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def _leaf(tree, path, i):
    for k in path:
        tree = tree[k]
    return np.asarray(tree if i is None else tree[i], np.float32)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(loss, grads by port name, prefill logits) of the JAX reference."""
    arch, over, jcfg = _cfgs(name)
    model = jax_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(name))
    batch = {k: jnp.asarray(v) for k, v in _batch(name).items()}
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(params, batch)
    logits = jax.jit(model.forward)(params, batch)
    if isinstance(logits, tuple):
        logits = logits[0]
    tcfg = reduce_config(ARCHS[arch], **over)
    g = {n: _leaf(grads, path, i)
         for n, path, i in lm_leaf_paths(tcfg, grads)}
    return float(loss), g, np.asarray(logits, np.float32)


@functools.lru_cache(maxsize=None)
def _one_rank(name, mb):
    """The port's parameters after one AdamW step on one rank."""
    arch, over, _ = _cfgs(name)
    cfg = reduce_config(ARCHS[arch], **over)
    bundle = make_train_step(build_model(cfg), make_optimizer("adamw",
                                                              lr=LR),
                             ShapeConfig("t", S, B, "train"),
                             microbatches=mb)
    params = params_from_numpy(_tree(name), cfg, "cpu", trainable=True)
    state = bundle.init_state(params)
    bundle(params, state, {k: torch.from_numpy(v)
                           for k, v in _batch(name).items()})
    return {n: p.detach().numpy().copy()
            for n, p in params.named_parameters()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_train")
    names = list(CONFIGS) + list(BF16)
    cases = [{"config": c, "fsdp": f, "mb": mb, "kind": "train",
              "mesh": m} for m, c, f, mb in TRAIN]
    cases += [{"config": c, "fsdp": False, "mb": 1, "kind": "prefill",
               "mesh": m} for m in MKEYS for c in CONFIGS]
    cases += [{"config": c, "fsdp": False, "mb": 1, "kind": "train",
               "mesh": "2x2"} for c in BF16]
    torch.save({"configs": {n: _cfgs(n)[:2] for n in names},
                "trees": {n: _tree(n) for n in names},
                "batches": {n: _batch(n) for n in names},
                "meshes": MESHES, "cases": cases}, out / "train_in.pt")
    run_ranks("train", out, timeout=400)
    return torch.load(out / "train_out.pt", weights_only=False)


@pytest.mark.parametrize("mkey,name,fsdp,mb", TRAIN)
def test_sharded_step_equals_the_reference(results, mkey, name, fsdp, mb):
    got = results[(mkey, name, fsdp, mb)]
    loss, grads, _ = _reference(name)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, atol=1e-4)
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4,
                                   atol=1e-4, err_msg=n)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads.values()))
    np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
    after = _one_rank(name, mb)
    for n, p in after.items():
        keep = np.abs(grads[n]) >= 1e-6
        np.testing.assert_allclose(got["params"][n][keep], p[keep],
                                   rtol=1e-5, atol=1e-5, err_msg=n)
        # the first moment is (1 - b1) g: the ZeRO-1 blocks line up
        np.testing.assert_allclose(got["moments"][n], 0.1 * grads[n],
                                   rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("mkey", MKEYS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_prefill_logits_equal_the_reference(results, mkey, name):
    _, _, logits = _reference(name)
    np.testing.assert_allclose(results[(mkey, name, "prefill")], logits,
                               rtol=1e-4, atol=1e-4)


def _normwise(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", list(BF16))
def test_sharded_bf16_step_agrees_normwise(results, name):
    got = results[("2x2", name, False, 1)]
    loss, grads, _ = _reference(name)
    assert abs(got["loss"] - loss) <= 2e-2 * abs(loss)
    flat = np.concatenate([grads[n].ravel() for n in sorted(grads)])
    mine = np.concatenate([got["grads"][n].ravel() for n in sorted(grads)])
    assert _normwise(mine, flat) <= 2e-2
