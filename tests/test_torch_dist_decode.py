"""The sharded decode step of every family on 4 gloo ranks against the JAX
reference's one-device ``decode_fn``, and its placements against the
reference's ``decode_specs`` placements.

Configs (the reference's ``reduce_config`` in fp32 with these overrides):
llama3.2-3b (4 heads, 4 kv heads), llama3.2-3b with 2 kv heads (on (1, 4)
they do not divide the model axis, so the KV cache's positions go over it
and the ranks combine their blocks' softmax statistics), granite-moe (2
layers, 4 experts: each rank's SwiGLU kernel form on its experts), zamba2
(2 groups of 2 mamba layers and a tail, state 16: ``h`` splits N, the conv
window its columns), xlstm (2 groups of one mLSTM and one sLSTM: ``C``
splits its value dim), whisper with 6 heads (on (1, 4) its caches'
positions go over ``model``; on (2, 2) 3 heads a rank) and the vision LM.
Each runs on (2, 2) and (1, 4): 10 decode steps of 4 sequences whose
lengths start 0, 1, 2 and 3 apart (so their new rows fall in different
ranks' blocks of positions), from a zero state whose cross-attention
caches ``xk``/``xv`` both sides are given the same random values (the
reference never fills them).  Every step's logits and the final state
equal the reference's to 1e-4, the one-device parity tolerance of
``tests/test_torch_xlstm.py`` and its siblings.

The placements need no processes: for every family at full width on
(2, 2), (1, 4) and (4, 1), the decode step ``build_step`` makes for a
decode shape (``make_decode_step(..., mesh=)``) has state
placements equal the reference's ``tree_shardings`` of its
``decode_specs`` on a ``jax.sharding.AbstractMesh`` (the reference's own
mesh tests fail on jax 0.9.0).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro.sharding import api as jax_api  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.train.step import build_step, make_decode_step  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.xdist_group("dist_decode")

B, LENGTH, STEPS = 4, 16, 10
OFFSETS = np.arange(B, dtype=np.int32)
F32 = dict(dtype="float32")
CONFIGS = {
    "llama": ("llama3.2-3b", F32),
    "llama_kv2": ("llama3.2-3b", dict(F32, n_kv_heads=2)),
    "granite": ("granite-moe-1b-a400m", dict(F32, n_layers=2)),
    "zamba2": ("zamba2-7b", F32),
    "xlstm": ("xlstm-1.3b", F32),
    "whisper": ("whisper-tiny", dict(F32, n_heads=6, n_kv_heads=6)),
    "vlm": ("llama-3.2-vision-11b", F32),
}
MESHES = [(2, 2), (1, 4)]
MKEYS = ["x".join(map(str, m)) for m in MESHES]
CASES = [(m, c) for m in MKEYS for c in CONFIGS]


def _jcfg(name):
    arch, over = CONFIGS[name]
    return jax_reduce(JAX_ARCHS[arch], **over)


@functools.lru_cache(maxsize=None)
def _tree(name):
    return jax.tree_util.tree_map(
        np.asarray, jax_build(_jcfg(name)).init(jax.random.PRNGKey(0)))


def _with_gates(tree):
    """Every cross block's xgate at 0.5 (at 0 the cross path adds
    nothing)."""
    for key in ("dec_blocks", "cross_blocks"):
        if key in tree:
            tree[key]["xgate"] = np.full_like(tree[key]["xgate"], 0.5)
    return tree


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """(tokens (STEPS, B), the cross caches' values by key)."""
    jcfg = _jcfg(name)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab, (STEPS, B)).astype(np.int32)
    state = jax.eval_shape(lambda: jax_build(jcfg).decode_init(B, LENGTH))
    cross = {k: rng.standard_normal(state[k].shape).astype(np.float32)
             for k in ("xk", "xv") if k in state}
    return tokens, cross


def _lens():
    return [(t + OFFSETS).astype(np.int32) for t in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(logits (STEPS, B, V), final state) of the reference's jitted
    ``decode_fn`` from its ``decode_init`` with the cross caches
    written."""
    model = jax_build(_jcfg(name))
    params = jax.tree_util.tree_map(jnp.asarray, _with_gates(_tree(name)))
    tokens, cross = _inputs(name)
    state = model.decode_init(B, LENGTH)
    for k, v in cross.items():
        state[k] = jnp.asarray(v, state[k].dtype)
    step = jax.jit(model.decode_fn)
    logits = []
    for tok, lens in zip(tokens, _lens()):
        lg, state = step(params, state, jnp.asarray(tok), jnp.asarray(lens))
        logits.append(np.asarray(lg, np.float32))
    return np.stack(logits), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), state)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_decode")
    torch.save({"configs": CONFIGS,
                "trees": {n: _with_gates(_tree(n)) for n in CONFIGS},
                "tokens": {n: _inputs(n)[0] for n in CONFIGS},
                "cross": {n: _inputs(n)[1] for n in CONFIGS},
                "lens": _lens(), "batch": B, "max_seq": LENGTH,
                "meshes": MESHES}, out / "decode_in.pt")
    run_ranks("decode", out, timeout=300)
    return torch.load(out / "decode_out.pt", weights_only=False)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mkey,name", CASES)
def test_sharded_decode_equals_the_reference(results, mkey, name):
    got = results[(mkey, name)]
    logits, state = _reference(name)
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-4, atol=1e-4)
    want = _leaves(state)
    have = _leaves(got["state"])
    assert set(have) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(have[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_kv_positions_go_over_model_where_kv_heads_do_not_divide(results):
    """On (1, 4) the 2-kv-head llama's and 6-head whisper's caches hold a
    block of positions a rank (4 of 16), the others a block of kv heads:
    the cases above ran both ways."""
    mesh = Mesh((1, 4), ("data", "model"))
    shape = ShapeConfig("decode", LENGTH, B, "decode")
    for name, want in (("llama_kv2", (None, "data", "model")),
                       ("whisper", (None, "data", "model")),
                       ("llama", (None, "data", None, "model"))):
        arch, over = CONFIGS[name]
        model = build_model(reduce_config(ARCHS[arch], **over))
        bundle = make_decode_step(model, mesh=mesh, shape=shape)
        assert bundle.in_shardings[1]["k"].spec == want, name


# ---------------------------------------------------------------------------
# placements against the reference's rule functions
# ---------------------------------------------------------------------------

PLACE_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
PLACE_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "zamba2-7b",
               "xlstm-1.3b", "whisper-tiny", "llama-3.2-vision-11b"]


def _trim(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh_key", list(PLACE_MESHES))
@pytest.mark.parametrize("arch", PLACE_ARCHS)
def test_decode_state_placements_equal_the_reference(arch, mesh_key):
    """Every decode state leaf's placement at full width (batch 8, a
    cache of 4096) is the reference's ``PartitionSpec``, and the logits
    go over (batch, model)."""
    dims = PLACE_MESHES[mesh_key]
    axes = ("data", "model")
    jmodel = jax_build(JAX_ARCHS[arch])
    jshape = JaxShape("decode", 4096, 8, "decode")
    jmesh = AbstractMesh(dims, axes)
    abstract = jax.eval_shape(lambda: jmodel.decode_init(8, 4096))
    ref = jax_api.tree_shardings(
        jmesh, jmodel.decode_specs(),
        jax_api.activation_rules(jmodel.cfg, jshape, jmesh), abstract)
    bundle = build_step(build_model(ARCHS[arch]), None, Mesh(dims, axes),
                        ShapeConfig("decode", 4096, 8, "decode"))
    got = _leaves(bundle.in_shardings[1])
    want = {k: _trim(tuple(v.spec)) for k, v in _leaves(ref).items()}
    assert {k: _trim(v.spec) for k, v in got.items()} == want
    assert bundle.out_shardings[0].spec == ("data", "model")
    assert bundle.in_shardings[2].spec == ("data",)
