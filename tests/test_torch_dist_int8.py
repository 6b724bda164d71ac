"""int8 AdamW moments on the mesh, on 4 gloo ranks, against the JAX
reference's int8 AdamW and the port's one-rank int8 steps; and the
moments' placements against the reference's ``opt_state_spec_tree``.

The reference quantises each parameter's flat global tensor in blocks of
256 elements and puts the block dim over ``("data", "model")`` (or
replicates it where the block count does not divide the mesh).  A
reduced fp32 llama (``tests/torch_dist_cases.py:int8_runs``) takes 2
steps of int8 AdamW on (2, 2) and on (4, 1) with FSDP forced, and its
one-rank twin the same 2 steps:

* given the gradients the mesh reduced (each parameter's block as the
  update receives it, gathered), the reference's
  ``make_optimizer("adamw", state_dtype="int8").update`` (op by op, as
  ``tests/test_torch_optim_offload.py`` runs it) from the same initial
  parameters reproduces the mesh's parameters within 1e-6, its ``scale``
  within 1e-6 and its ``q`` within one step (that file's gate: XLA's and
  torch's roundings may put an entry across a tie), and the port's
  one-rank optimizer reproduces them bit for bit: the re-layout into the
  flat blocks and back loses nothing;
* against the one rank's own steps (its own gradients, which part from
  the mesh's in the last bits) the losses agree to 1e-5, each
  dequantised moment lies within one quantisation step of its block
  (and the two scales' difference), and the ``q`` entries that differ
  differ by 1.  The parameters are not compared there: where a block's
  scale rounds a second moment to 0 the update is ``m / eps``, and the
  last-bit difference of the gradients moves it by up to 1e-1.

Each rank holds only its blocks of ``q`` and ``scale``
(``bundle.init_state`` allocates them at their block shapes).
``tests/test_torch_optim_offload.py`` holds the one-rank int8 AdamW to
the reference on its own inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro.sharding import api as jax_api  # noqa: E402
from repro.train.step import opt_state_spec_tree as jax_opt_specs  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from torch_dist_cases import int8_runs  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.xdist_group("dist_int8")

CASES = [((2, 2), None), ((4, 1), True)]
KEYS = [("x".join(map(str, m)), f) for m, f in CASES]


def _inputs():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (4, 16)).astype(np.int64)
    return {"config": ("llama3.2-3b", dict(dtype="float32")),
            "batch": {"tokens": tokens,
                      "targets": np.roll(tokens, -1, axis=1)},
            "lr": 3e-4, "steps": 2, "cases": CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_int8")
    inp = _inputs()
    torch.save(inp, out / "int8_in.pt")
    run_ranks("int8", out, timeout=240)
    got = torch.load(out / "int8_out.pt", weights_only=False)
    replay = {k: int8_runs(inp, grads=g["grads"]) for k, g in got.items()}
    return got, replay, int8_runs(inp), \
        {k: _reference(inp, g["grads"]) for k, g in got.items()}


def _reference(inp, grads):
    """The reference's int8 AdamW from the port's initial parameters (the
    seed's, by port name) over ``grads``, a step's whole gradients each:
    (parameters, moments) as numpy."""
    arch, over = inp["config"]
    model = build_model(reduce_config(ARCHS[arch], **over))
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in
              model.init(0, device="cpu", trainable=True).named_parameters()}
    opt = jax_opt.make_optimizer("adamw", state_dtype="int8", lr=inp["lr"])
    state = opt.init(params)
    for g in grads:
        params, state = opt.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, params)
    assert int(state["count"]) == len(grads)
    return jax.tree_util.tree_map(np.asarray, (params, state["mu"]))


@pytest.mark.parametrize("key", KEYS, ids=[f"{m}-fsdp{f}" for m, f in KEYS])
def test_sharded_int8_step_is_the_reference_update_of_its_gradients(runs,
                                                                    key):
    got, (params, mu) = runs[0][key], runs[3][key]
    assert set(params) == set(got["params"])
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n], p, rtol=0, atol=1e-6,
                                   err_msg=n)
        for k in ("m", "v"):
            a, b = got["moments"][n][k], mu[n][k]
            assert a["q"].shape == b["q"].shape, (n, k)
            dq = np.abs(a["q"].astype(np.int32) - b["q"].astype(np.int32))
            assert dq.max() <= 1, (n, k)
            np.testing.assert_allclose(a["scale"], b["scale"], rtol=1e-6,
                                       err_msg=f"{n}.{k}")


@pytest.mark.parametrize("key", KEYS, ids=[f"{m}-fsdp{f}" for m, f in KEYS])
def test_sharded_int8_step_is_the_one_rank_update_of_its_gradients(runs,
                                                                   key):
    got, replay = runs[0][key], runs[1][key]
    assert got["count"] == replay["count"] == 2
    for n, p in replay["params"].items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)
        for k in ("m", "v"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    got["moments"][n][k][part], replay["moments"][n][k][part],
                    err_msg=f"{n}.{k}.{part}")


@pytest.mark.parametrize("key", KEYS, ids=[f"{m}-fsdp{f}" for m, f in KEYS])
def test_sharded_int8_moments_within_a_step_of_one_rank(runs, key):
    got, own = runs[0][key], runs[2]
    np.testing.assert_allclose(got["losses"], own["losses"], rtol=1e-5)
    flips = 0
    for n in own["moments"]:
        for k in ("m", "v"):
            a, b = got["moments"][n][k], own["moments"][n][k]
            dq = np.abs(a["q"].astype(np.int32) - b["q"].astype(np.int32))
            assert dq.max() <= 1, (n, k)
            flips += int(dq.sum())
            step = np.maximum(a["scale"], b["scale"]) \
                + 127 * np.abs(a["scale"] - b["scale"])
            deq = np.abs(a["q"] * a["scale"] - b["q"] * b["scale"])
            assert (deq <= step).all(), (n, k)
    n_q = sum(2 * m["m"]["q"].size for m in own["moments"].values())
    assert flips <= 1e-3 * n_q


def test_each_rank_allocates_only_its_blocks(runs):
    """On (2, 2) a leaf of nb blocks, nb a multiple of 4, holds nb / 4 a
    rank; others (a norm scale of 64 elements: 1 block) hold all."""
    got = runs[0][("2x2", None)]
    for n, whole in got["moments"].items():
        nb = whole["m"]["q"].shape[0]
        want = nb // 4 if nb % 4 == 0 else nb
        assert got["local_blocks"][n] == (want, 256), n
    assert any(m["m"]["q"].shape[0] % 4 for m in got["moments"].values())


PLACE = {"2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}


@pytest.mark.parametrize("mesh_key", list(PLACE))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-34b",
                                  "whisper-tiny"])
def test_int8_moment_placements_equal_the_reference(arch, mesh_key):
    """The int8 train step's ``q`` and ``scale`` placements are the
    reference's ``opt_state_spec_tree`` under its rules, applied to the
    port's per-parameter int8 tree (the reference quantises a stacked
    leaf over every layer at once, the port each layer's): ``("data",
    "model")`` on the block dim, dropped to replicated where nb does not
    divide 4 (whisper-tiny's 384-element norms: 2 blocks)."""
    dims = PLACE[mesh_key]
    cfg = ARCHS[arch]
    model = build_model(cfg)
    shape = ShapeConfig("train_4k", 4096, 256, "train")
    bundle = make_train_step(model, make_optimizer("adamw",
                                                   state_dtype="int8"),
                             shape, mesh=Mesh(dims, ("data", "model")))
    jmesh = AbstractMesh(dims, ("data", "model"))
    act = jax_api.activation_rules(JAX_ARCHS[arch], JaxShape(
        "train_4k", 4096, 256, "train"), jmesh)
    shapes = model.param_shapes()

    def abstract(s):
        nb = -(-int(np.prod(s)) // 256)
        q = {"q": jax.ShapeDtypeStruct((nb, 256), jnp.int8),
             "scale": jax.ShapeDtypeStruct((nb, 1), jnp.float32)}
        return {"m": q, "v": dict(q)}

    opt = {"mu": {n: abstract(s) for n, s in shapes.items()},
           "count": jax.ShapeDtypeStruct((), jnp.int32)}
    ref = jax_api.tree_shardings(
        jmesh, jax_opt_specs(opt, model.param_specs()),
        {**act, "embed": ("data",), "qblocks": ("data", "model")}, opt)
    got = bundle.in_shardings[1]
    odd = 0
    for n, s in shapes.items():
        for k in ("m", "v"):
            for part in ("q", "scale"):
                want = tuple(ref["mu"][n][k][part].spec)
                while want and want[-1] is None:
                    want = want[:-1]
                assert got["mu"][n][k][part].spec == want, (n, k, part)
        odd += -(-int(np.prod(s)) // 256) % 4 != 0
    assert got["count"].spec == ()
    if arch == "whisper-tiny":
        assert odd > 0
