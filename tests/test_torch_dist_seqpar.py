"""A batch that does not split over the mesh, on 4 gloo ranks, against the
JAX reference's one-device functions and the port's one-rank steps; and
the placements of batch-1 long-context decode against the reference's
rule functions.

Where the global batch does not divide (pod, data), the reference's
``activation_rules`` give ``batch`` None: every ``data`` rank holds every
row, and the decode state's sequence goes over ``data`` instead (the KV
caches' positions, ``kv_seq``, with ``model`` appended where the kv heads
do not divide it; the mLSTM state's key dim, ``sp_seq``).  The ranks run
on (2, 2), (4, 1) and (1, 4) (``tests/torch_dist_cases.py:seqpar``):

* every family's decode at batch 1 (reduced fp32 configs; llama also
  with one kv head, whose cache's positions then go over ``("data",
  "model")`` on (2, 2)), 6 steps from a state of seeded normals at
  lengths 5 to 10, so the new rows fall in different ranks' blocks of
  positions: every step's logits and the final state, gathered, against
  the reference's jitted ``decode_fn`` from the same state at 1e-4 (the
  one-device parity tolerance of ``tests/test_torch_dist_decode.py``),
  and against the port's one-rank decode at 1e-5;
* llama, granite-moe, zamba2 and xlstm trained one AdamW step at batches
  1 and 3 (llama and zamba2 with FSDP forced too): the loss, the grad
  norm and each reduced gradient leaf against ``jax.value_and_grad`` of
  the reference's loss, and the prefill logits against its forward, at
  1e-4; the same and the updated parameters against the one-rank step
  at 1e-4 (logits 1e-5).

Both sides start from the reference's parameters (``init(PRNGKey(0))``,
every cross block's ``xgate`` at 0.5).  The one-rank runs are the same
function without a mesh (``seqpar_runs(inp)``), in this process, as the
reference's are.  The placements of zamba2-7b and
xlstm-1.3b at full width at ``long_500k`` (524,288 positions, batch 1)
need no processes: the port's decode bundle against the reference's
``tree_shardings`` of its ``decode_specs`` under its ``activation_rules``
on a ``jax.sharding.AbstractMesh``.
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro.sharding import api as jax_api  # noqa: E402
from repro_torch.convert import lm_leaf_paths, params_from_numpy  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import build_step  # noqa: E402
from torch_dist_cases import seqpar_runs  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.xdist_group("dist_seqpar")

LENGTH, STEPS, START, SEQ = 16, 6, 5, 16
F32 = dict(dtype="float32")
DECODE_CONFIGS = {
    "llama": ("llama3.2-3b", F32),
    "llama_kv1": ("llama3.2-3b", dict(F32, n_kv_heads=1)),
    "granite": ("granite-moe-1b-a400m", dict(F32, n_layers=2)),
    "zamba2": ("zamba2-7b", F32),
    "xlstm": ("xlstm-1.3b", F32),
    "whisper": ("whisper-tiny", dict(F32, n_heads=6, n_kv_heads=6)),
    "vlm": ("llama-3.2-vision-11b", F32),
}
TRAIN_CONFIGS = {
    "llama": ("llama3.2-3b", F32),
    "granite": ("granite-moe-1b-a400m", dict(F32, n_layers=2)),
    "zamba2": ("zamba2-7b", F32),
    "xlstm": ("xlstm-1.3b", F32),
}
TRAIN_CASES = [(n, b, False) for n in TRAIN_CONFIGS for b in (1, 3)] + \
    [(n, b, True) for n in ("llama", "zamba2") for b in (1, 3)]
MESHES = [(2, 2), (4, 1), (1, 4)]
MKEYS = ["x".join(map(str, m)) for m in MESHES]


def _jcfg(name):
    arch, over = {**DECODE_CONFIGS, **TRAIN_CONFIGS}[name]
    return jax_reduce(JAX_ARCHS[arch], **over)


def _tree(name):
    """The reference's parameters, every cross block's ``xgate`` at 0.5
    (at 0, the init's value, the cross path adds nothing)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jax_build(_jcfg(name)).init(jax.random.PRNGKey(0)))
    for key in ("dec_blocks", "cross_blocks"):
        if key in tree:
            tree[key]["xgate"] = np.full_like(tree[key]["xgate"], 0.5)
    return tree


def _inputs():
    assert all(TRAIN_CONFIGS[n] == DECODE_CONFIGS[n] for n in TRAIN_CONFIGS)
    rng = np.random.default_rng(11)
    states = {}
    for name in DECODE_CONFIGS:
        abstract = jax.eval_shape(
            lambda: jax_build(_jcfg(name)).decode_init(1, LENGTH))
        states[name] = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            abstract)
    batches = {}
    for name in TRAIN_CONFIGS:
        vocab = _jcfg(name).vocab
        for b in (1, 3):
            tokens = rng.integers(0, vocab, (b, SEQ)).astype(np.int64)
            batches[(name, b)] = {"tokens": tokens,
                                  "targets": np.roll(tokens, -1, axis=1)}
    return {"decode_configs": DECODE_CONFIGS, "train_configs": TRAIN_CONFIGS,
            "train_cases": TRAIN_CASES, "states": states,
            "trees": {n: _tree(n) for n in DECODE_CONFIGS},
            "tokens": [rng.integers(0, 256, (1,)).astype(np.int64)
                       for _ in range(STEPS)],
            "lens": [np.array([START + t], np.int64) for t in range(STEPS)],
            "batches": batches, "max_seq": LENGTH, "meshes": MESHES}


def _leaf(tree, path, i):
    for k in path:
        tree = tree[k]
    return np.asarray(tree if i is None else tree[i], np.float32)


def _reference(inp):
    """The reference's results on ``inp``: each decode config's logits
    (STEPS, 1, V) and final state from its jitted ``decode_fn``; each
    train batch's loss, grad norm and gradients by port name
    (``jax.value_and_grad(loss_fn)``) and prefill logits (``forward``)."""
    out = {}
    for name in DECODE_CONFIGS:
        model = jax_build(_jcfg(name))
        params = jax.tree_util.tree_map(jnp.asarray, inp["trees"][name])
        state = jax.tree_util.tree_map(jnp.asarray, inp["states"][name])
        step = jax.jit(model.decode_fn)
        logits = []
        for tok, lens in zip(inp["tokens"], inp["lens"]):
            lg, state = step(params, state, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(lens, jnp.int32))
            logits.append(np.asarray(lg, np.float32))
        out[("decode", name)] = {"logits": np.stack(logits),
                                 "state": jax.tree_util.tree_map(
                                     lambda a: np.asarray(a, np.float32),
                                     state)}
    for name, (arch, over) in TRAIN_CONFIGS.items():
        model = jax_build(_jcfg(name))
        params = jax.tree_util.tree_map(jnp.asarray, inp["trees"][name])
        # one compile of the loss, its gradient and the forward a batch
        fn = jax.jit(lambda p, b, model=model: (
            jax.value_and_grad(model.loss_fn)(p, b), model.forward(p, b)))
        tcfg = reduce_config(ARCHS[arch], **over)
        for b in (1, 3):
            batch = {k: jnp.asarray(v, jnp.int32)
                     for k, v in inp["batches"][(name, b)].items()}
            (loss, grads), logits = fn(params, batch)
            if isinstance(logits, tuple):
                logits = logits[0]
            g = {n: _leaf(grads, path, i)
                 for n, path, i in lm_leaf_paths(tcfg, grads)}
            out[("train", name, b)] = {
                "loss": float(loss), "grads": g,
                "grad_norm": float(np.sqrt(sum(
                    np.sum(np.square(v, dtype=np.float64))
                    for v in jax.tree_util.tree_leaves(grads)))),
                "logits": np.asarray(logits, np.float32)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_seqpar")
    inp = _inputs()
    torch.save(inp, out / "seqpar_in.pt")
    # the ranks run in their own processes while this one computes the
    # reference's and the one-rank results
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, "seqpar", out, timeout=300)
        ref, one = _reference(inp), seqpar_runs(inp)
        ranks.result()
    return torch.load(out / "seqpar_out.pt", weights_only=False), one, ref, \
        inp


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _assert_decode_close(got, want, tol):
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol,
                               atol=tol)
    have, ref = _leaves(got["state"]), _leaves(want["state"])
    assert set(have) == set(ref)
    for k, w in ref.items():
        np.testing.assert_allclose(have[k], w, rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(DECODE_CONFIGS))
@pytest.mark.parametrize("mkey", MKEYS)
def test_batch1_decode_equals_the_reference(runs, mkey, name):
    _assert_decode_close(runs[0][(mkey, "decode", name)],
                         runs[2][("decode", name)], 1e-4)


@pytest.mark.parametrize("name", list(DECODE_CONFIGS))
@pytest.mark.parametrize("mkey", MKEYS)
def test_batch1_decode_equals_one_rank(runs, mkey, name):
    _assert_decode_close(runs[0][(mkey, "decode", name)],
                         runs[1][("decode", name)], 1e-5)


@pytest.mark.parametrize("name,b,fsdp", TRAIN_CASES)
@pytest.mark.parametrize("mkey", MKEYS)
def test_unsplit_batch_train_and_prefill_equal_the_reference(runs, mkey,
                                                             name, b, fsdp):
    got, want = runs[0][(mkey, "train", name, b, fsdp)], \
        runs[2][("train", name, b)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert set(got["grads"]) == set(want["grads"])
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name,b,fsdp", TRAIN_CASES)
@pytest.mark.parametrize("mkey", MKEYS)
def test_unsplit_batch_train_and_prefill_equal_one_rank(runs, mkey, name, b,
                                                        fsdp):
    got, want = runs[0][(mkey, "train", name, b, fsdp)], \
        runs[1][("train", name, b, False)]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
    assert set(got["grads"]) == set(want["grads"])
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4, atol=1e-4,
                                   err_msg=n)
    # the parameters after the step: one rank's AdamW update of the mesh's
    # own reduced gradients, bit for bit (each rank updated its block of
    # each parameter and nothing twice).  Against the one-rank step's own
    # parameters AdamW's first step, about lr x g / (|g| + eps), turns the
    # gradients' last-bit differences where |g| is near 1e-6 into 1e-5
    replay = _adamw_step(runs[3], name, got["grads"])
    assert set(replay) == set(got["params"])
    for n, p in replay.items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)


def _adamw_step(inp, name, grads):
    """The port's parameters from the reference's after one rank's AdamW
    step (the train cases' optimizer) on ``grads``."""
    arch, over = TRAIN_CONFIGS[name]
    params = params_from_numpy(inp["trees"][name],
                               reduce_config(ARCHS[arch], **over), "cpu",
                               trainable=True)
    named = {n: p.data for n, p in params.named_parameters()}
    opt = make_optimizer("adamw", lr=1e-2)
    opt.update_({n: torch.from_numpy(grads[n]) for n in named},
                opt.init(named), named)
    return {n: t.numpy() for n, t in named.items()}


def test_one_kv_head_puts_positions_over_data_and_model():
    """At batch 1 on (2, 2) one kv head does not divide ``model``: the
    cache's positions go over both axes (blocks of 4 of 16); with 4 kv
    heads over ``data`` only, the heads over ``model``."""
    mesh = Mesh((2, 2), ("data", "model"))
    shape = SHAPES["long_500k"].__class__("d", LENGTH, 1, "decode")
    for name, want in (("llama_kv1", (None, None, ("data", "model"))),
                       ("llama", (None, None, "data", "model"))):
        arch, over = DECODE_CONFIGS[name]
        bundle = build_step(build_model(reduce_config(ARCHS[arch], **over)),
                            None, mesh, shape)
        assert bundle.in_shardings[1]["k"].spec == want, name
        assert bundle.out_shardings[0].spec == (None, "model")
        assert bundle.in_shardings[2].spec == ()


def _trim(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh_key", ["2x2", "4x1", "1x4"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_long_500k_placements_equal_the_reference(arch, mesh_key):
    """zamba2-7b's KV cache (13 x 524,288 x 32 x 112) goes over (data,
    model) by positions and kv heads, its SSM state over ``model``;
    xlstm-1.3b's ``C`` by its key dim over ``data``
    and its value dim over ``model``: every leaf as the reference places
    it at full width."""
    dims = tuple(int(x) for x in mesh_key.split("x"))
    axes = ("data", "model")
    jmodel = jax_build(JAX_ARCHS[arch])
    jshape = JAX_SHAPES["long_500k"]
    jmesh = AbstractMesh(dims, axes)
    abstract = jax.eval_shape(lambda: jmodel.decode_init(
        jshape.global_batch, jshape.seq_len))
    ref = jax_api.tree_shardings(
        jmesh, jmodel.decode_specs(),
        jax_api.activation_rules(jmodel.cfg, jshape, jmesh), abstract)
    bundle = build_step(build_model(ARCHS[arch]), None, Mesh(dims, axes),
                        SHAPES["long_500k"])
    got = {k: _trim(v.spec) for k, v in _leaves(bundle.in_shardings[1])
           .items()}
    assert got == {k: _trim(tuple(v.spec)) for k, v in _leaves(ref).items()}
    if dims[0] > 1:
        assert bundle.act_rules["batch"] is None
        assert bundle.out_shardings[0].spec == (None, "model")
    if arch == "zamba2-7b" and dims == (2, 2):
        assert got["attn.k"] == (None, None, "data", "model")
    if arch == "xlstm-1.3b" and dims[0] > 1:
        assert got["m.C"][3] == "data"
