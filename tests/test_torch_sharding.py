"""The port's placement tables against the reference's rule functions.

For every architecture in ``ARCHS`` (every family), on the meshes (1, 1),
(2, 2), (4, 1), (1, 4) and (pod 2, data 2, model 1), with FSDP forced on
and off: every parameter leaf's placement, and every AdamW moment's, is
the reference's ``PartitionSpec``.  The reference's rules need only the
mesh's axis names and sizes, so it gets a ``jax.sharding.AbstractMesh``
and the port an abstract ``Mesh``: no devices on either side.  A stacked
reference leaf carries a leading unsharded layer axis, which the port's
per-layer parameters do not have.  ``activation_rules`` agree for a train
shape, a decode shape, batch 1, and kv heads that do not divide the model
axis.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as _jax_reduce  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.sharding import api as jax_api  # noqa: E402
from repro.train.step import opt_state_spec_tree as jax_opt_specs  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_leaf_paths  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.sharding import api  # noqa: E402
from repro_torch.sharding.rules import (DEFAULT_RULES,  # noqa: E402
                                        NamedSharding, constrain, use_mesh)
from repro_torch.train.step import opt_state_spec_tree  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "pod2x2x1": ((2, 2, 1), ("pod", "data", "model"))}


def _trim(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    model = jax_build(JAX_ARCHS[arch])
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return model, abstract


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _reference_param_specs(arch, mesh_key, fsdp):
    model, abstract = _reference(arch)
    mesh = AbstractMesh(*MESHES[mesh_key])
    shard = jax_api.param_shardings(mesh, model.cfg, model.param_specs(),
                                    abstract, fsdp=fsdp)
    return {name: (_trim(tuple(_leaf(shard, path).spec)), i)
            for name, path, i in lm_leaf_paths(ARCHS[arch], abstract)}


def _port_mesh(mesh_key):
    return Mesh(*MESHES[mesh_key])


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_placements_equal_the_reference(arch, mesh_key, fsdp):
    want = _reference_param_specs(arch, mesh_key, fsdp)
    model = build_model(ARCHS[arch])
    got = api.param_shardings(_port_mesh(mesh_key), model.cfg,
                              model.param_specs(), model.param_shapes(),
                              fsdp=fsdp)
    assert set(got) == set(want)
    for name, sh in got.items():
        ref, stacked = want[name]
        mine = ((None,) + sh.spec) if stacked is not None else sh.spec
        assert _trim(mine) == ref, (name, mine, ref)


def _reference_moment_specs(arch, mesh_key, shape, state_dtype):
    model, abstract = _reference(arch)
    mesh = AbstractMesh(*MESHES[mesh_key])
    act = jax_api.activation_rules(model.cfg, shape, mesh)
    act["qblocks"] = ("data", "model")
    opt = jax.eval_shape(lambda: jax_make_optimizer(
        "adamw", state_dtype=state_dtype).init(abstract))
    o_specs = jax_opt_specs(opt, model.param_specs())
    shard = jax_api.tree_shardings(
        mesh, o_specs, {**act, "embed": ("data",),
                        "qblocks": ("data", "model")}, opt)
    return shard


def _port_moment_state(model, state_dtype):
    """An AdamW state's structure and shapes, nothing allocated."""
    def one(shape):
        if state_dtype == "int8":
            nb = -(-int(np.prod(shape)) // 256)
            q = {"q": (nb, 256), "scale": (nb, 1)}
            return {"m": q, "v": dict(q)}
        return {"m": tuple(shape), "v": tuple(shape)}
    return {"mu": {n: one(s) for n, s in model.param_shapes().items()},
            "count": ()}


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moment_placements_equal_the_reference(arch, mesh_key, state_dtype):
    """fp32 moments take the parameter's axes with ``embed`` over data
    (ZeRO-1); an int8 moment's blocks go over (data, model) jointly.  An
    int8 leaf of a stacked parameter is one quantised tree over every
    layer in the reference and one per layer in the port, so its block
    count (and with it the divisibility drop) differs: those are compared
    only for the unstacked leaves."""
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    ref = _reference_moment_specs(arch, mesh_key, JaxShape(
        "train_4k", 4096, 256, "train"), state_dtype)
    model = build_model(ARCHS[arch])
    mesh = _port_mesh(mesh_key)
    state = _port_moment_state(model, state_dtype)
    act = api.activation_rules(model.cfg, shape, mesh)
    specs = opt_state_spec_tree(state, model.param_specs())
    got = api.tree_shardings(mesh, specs,
                             {**act, "embed": ("data",),
                              "qblocks": ("data", "model")}, state)
    assert got["count"].spec == () == _trim(tuple(ref["count"].spec))
    _, abstract = _reference(arch)
    for name, path, i in lm_leaf_paths(ARCHS[arch], abstract):
        for k in ("m", "v"):
            mine, theirs = got["mu"][name][k], _leaf(ref["mu"], path)[k]
            if state_dtype == "int8":
                if i is not None:
                    continue
                for part in ("q", "scale"):
                    assert mine[part].spec == _trim(
                        tuple(theirs[part].spec)), (name, part)
                continue
            spec = ((None,) + mine.spec) if i is not None else mine.spec
            assert _trim(spec) == _trim(tuple(theirs.spec)), (name, k)


ACT_SHAPES = {"train": (4096, 256, "train"), "decode": (32768, 16, "decode"),
              "batch1": (32768, 1, "decode"), "prefill": (4096, 2, "prefill")}


@pytest.mark.parametrize("shape_key", list(ACT_SHAPES))
@pytest.mark.parametrize("mesh_key", ["2x2", "1x4", "pod2x2x1"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "llama-3.2-vision-11b",
                                  "zamba2-7b", "whisper-tiny",
                                  "granite-moe-1b-a400m"])
def test_activation_rules_equal_the_reference(arch, mesh_key, shape_key):
    """whisper-tiny's 6 heads and llama3.2-3b's 8 kv heads against a model
    axis of 4 are the non-divisible cases (kv_seq over model at decode)."""
    s, b, kind = ACT_SHAPES[shape_key]
    model, _ = _reference(arch)
    ref = jax_api.activation_rules(model.cfg, JaxShape("s", s, b, kind),
                                   AbstractMesh(*MESHES[mesh_key]))
    mine = api.activation_rules(ARCHS[arch], ShapeConfig("s", s, b, kind),
                                _port_mesh(mesh_key))
    assert mine == ref


def test_default_rules_are_the_reference_table_without_qkv():
    from repro.sharding.rules import DEFAULT_RULES as REF
    assert DEFAULT_RULES == REF
    assert "qkv" not in DEFAULT_RULES


def test_fsdp_threshold_covers_the_vision_and_3b_lms():
    """The reference's size rule: fp32 parameters above 8e9 bytes."""
    for arch, on in (("llama3.2-3b", True), ("llama-3.2-vision-11b", True),
                     ("whisper-tiny", False), ("xlstm-1.3b", False)):
        assert api.fsdp_on(ARCHS[arch]) is on
        assert bool(jax_api.param_rules(
            JAX_ARCHS[arch], AbstractMesh((2, 2), ("data", "model")))
            ["embed"]) is on


def test_placement_blocks_and_constrain():
    mesh = Mesh((2, 2), ("data", "model"))
    sh = NamedSharding(mesh, (("data", "model"), None))
    t = torch.arange(32).reshape(8, 4)
    blocks = [sh.shard(t, {"data": d, "model": m})
              for d in range(2) for m in range(2)]
    assert torch.equal(torch.cat(blocks), t)          # row-major over axes
    assert sh.replication() == 1
    assert NamedSharding(mesh, (None, "model")).replication() == 2
    with use_mesh(mesh, {"batch": ("data",)}):
        assert constrain(t, "batch", None).shape == (4, 4)
        assert constrain(t, "batch").shape == (8, 4)   # names != dims
    assert constrain(t, "batch", None) is t            # no mesh


def test_meshes_the_port_cannot_build_raise():
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    with pytest.raises(NotImplementedError, match="256"):
        make_production_mesh()
    with pytest.raises(NotImplementedError, match="512"):
        make_production_mesh(multi_pod=True)
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh((2, 2), ("data", "model"), device="cpu")


@pytest.mark.parametrize("case", ["xlstm", "int8", "batch",
                                  "decode_batch"])
def test_sharded_step_refuses_what_it_does_not_run(case):
    """xLSTM heads that do not divide the model axis raise when the step
    is built, naming its ROADMAP item (no process group needed: the
    placements are computed first).  int8 AdamW moments, a train batch
    that does not split over the mesh and a decode batch that does not
    split, refused until the port ran them, now build with the
    reference's placements: the int8 ``q`` and ``scale`` blocks over
    (data, model), or replicated where their count does not divide 4; the
    activation rules (``batch`` None for a batch of 3 on (2, 2), the
    caches' positions over ``data``) and the batch, logits and decode
    state placed by them."""
    import jax.numpy as jnp

    from repro_torch.models.model import reduce_config
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import make_decode_step, make_train_step
    mesh = Mesh((2, 2), ("data", "model"))
    jmesh = AbstractMesh((2, 2), ("data", "model"))
    if case == "xlstm":
        model = build_model(reduce_config(ARCHS["xlstm-1.3b"], n_heads=1))
        with pytest.raises(NotImplementedError, match="item 11:"):
            make_train_step(model, make_optimizer("adamw"),
                            ShapeConfig("t", 16, 4, "train"), mesh=mesh)
        return
    cfg = reduce_config(ARCHS["llama3.2-3b"])
    jcfg = _jax_reduce(JAX_ARCHS["llama3.2-3b"])
    model = build_model(cfg)
    if case == "decode_batch":
        bundle = make_decode_step(model, mesh=mesh,
                                  shape=ShapeConfig("d", 16, 3, "decode"))
        jshape = JaxShape("d", 16, 3, "decode")
        jmodel = jax_build(jcfg)
        act = jax_api.activation_rules(jcfg, jshape, jmesh)
        ref = jax_api.tree_shardings(
            jmesh, jmodel.decode_specs(), act,
            jax.eval_shape(lambda: jmodel.decode_init(3, 16)))
        assert bundle.act_rules == act
        for k in ("k", "v"):
            assert bundle.in_shardings[1][k].spec == _trim(
                tuple(ref[k].spec)) == (None, None, "data", "model")
        assert bundle.in_shardings[2].spec == ()
        assert bundle.out_shardings[0].spec == (None, "model")
        return
    opt = make_optimizer("adamw", state_dtype="int8" if case == "int8"
                         else "float32")
    batch = 3 if case == "batch" else 4
    bundle = make_train_step(model, opt, ShapeConfig("t", 16, batch,
                                                     "train"), mesh=mesh)
    act = jax_api.activation_rules(jcfg, JaxShape("t", 16, batch, "train"),
                                   jmesh)
    assert bundle.act_rules == {**act, "qblocks": ("data", "model")}
    assert bundle.in_shardings[2].spec == (() if case == "batch"
                                           else ("data",))
    if case == "int8":
        shapes = model.param_shapes()

        def q(s):
            nb = -(-int(np.prod(s)) // 256)
            return {"q": jax.ShapeDtypeStruct((nb, 256), jnp.int8),
                    "scale": jax.ShapeDtypeStruct((nb, 1), jnp.float32)}

        opt_state = {"mu": {n: {"m": q(s), "v": q(s)}
                            for n, s in shapes.items()},
                     "count": jax.ShapeDtypeStruct((), jnp.int32)}
        ref = jax_api.tree_shardings(
            jmesh, jax_opt_specs(opt_state, model.param_specs()),
            {**act, "embed": ("data",), "qblocks": ("data", "model")},
            opt_state)
        for n in shapes:
            for part in ("q", "scale"):
                assert bundle.in_shardings[1]["mu"][n]["m"][part].spec == \
                    _trim(tuple(ref["mu"][n]["m"][part].spec)), (n, part)


@pytest.mark.parametrize("mesh_key", ["1x1", "2x2", "4x1", "1x4"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m",
                                  "zamba2-7b", "whisper-tiny",
                                  "llama-3.2-vision-11b", "xlstm-1.3b"])
def test_partial_over_model_names_what_the_ranks_split(arch, mesh_key):
    """The replicated parameters whose gradients the step sums over
    ``model``, as the modules' specs declare them: every attention weight
    where the activation rules split the heads, the router where the
    placement splits the experts, a mamba layer's ``A_log``, ``D`` and
    ``dt_bias`` and an mLSTM block's ``b_if`` wherever ``model`` has more
    than one rank; nothing on a ``model`` axis of one."""
    model = build_model(ARCHS[arch])
    mesh = _port_mesh(mesh_key)
    shape = ShapeConfig("t", 4096, 4, "train")
    act = api.activation_rules(model.cfg, shape, mesh)
    p_shard = api.param_shardings(mesh, model.cfg, model.param_specs(),
                                  model.param_shapes())
    with use_mesh(mesh, act):
        got = api.partial_over_model(model.cfg, model.specs(), p_shard)
    split = mesh.shape["model"] > 1
    want = set()
    for n, sh in p_shard.items():
        owner, _, leaf = n.rpartition(".")
        kind = owner.rpartition(".")[2]
        if kind in ("attn", "xattn") and split and act.get("heads"):
            want.add(n)
        elif kind == "moe" and leaf == "router" and split \
                and "model" in p_shard[f"{owner}.gate"].dim_axes(0):
            want.add(n)
        elif kind == "ssm" and leaf in ("A_log", "D", "dt_bias") and split:
            want.add(n)
        elif kind == "mlstm" and leaf == "b_if" and split:
            want.add(n)
    assert got == want
