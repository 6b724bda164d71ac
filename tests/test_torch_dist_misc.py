"""The pod layer's other multi-rank pieces on 4 gloo ranks: the
compressed cross-pod gradient mean, the collective tally of a sharded
step, the reference's AdamW state carried onto a mesh, and a sharded
checkpoint saved on one mesh and restored on another or on one rank.

One child process runs every rank (``tests/torch_dist_util.py``, under a
hard limit); the tests hold what rank 0 (or each rank) wrote to the
reference and to the one-rank port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch.hlo_analysis import analyze_collectives as ref_analyze  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro.optim import compression as jax_comp  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import adamw_state_from_numpy  # noqa: E402
from repro_torch.launch.comm_analysis import analyze_collectives  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)

# the module's ranks start once, in its module fixture: under any xdist
# mode that splits a file (``--dist loadgroup``) its tests stay together
pytestmark = pytest.mark.xdist_group("dist_misc")

ARCH = "llama3.2-3b"
OVER = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            vocab=512, attention_impl="pallas", block_q=32, block_kv=32,
            dtype="float32")
GRAD_SHAPES = {"w": (64, 32), "b": (300,)}      # 300: a ragged last block


def _jcfg():
    return jax_reduce(JAX_ARCHS[ARCH], **dict(OVER, attention_impl="naive"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_misc")
    rng = np.random.default_rng(3)
    grads = {k: rng.standard_normal((4,) + s).astype(np.float32)
             for k, s in GRAD_SHAPES.items()}
    residual = {k: (0.01 * rng.standard_normal((4,) + s)).astype(np.float32)
                for k, s in GRAD_SHAPES.items()}
    model = jax_build(_jcfg())
    params = model.init(jax.random.PRNGKey(0))
    opt = jax_make_optimizer("adamw")
    g = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), params)
    _, state = opt.update(g, opt.init(params), params)
    toks = rng.integers(0, 512, (4, 33)).astype(np.int32)
    payload = {"grads": grads, "residual": residual, "config": (ARCH, OVER),
               "tree": jax.tree_util.tree_map(np.asarray, params),
               "state": jax.tree_util.tree_map(np.asarray, state),
               "batch": {"tokens": toks[:, :-1], "targets": toks[:, 1:]}}
    torch.save(payload, out / "misc_in.pt")
    return out, payload


@pytest.fixture(scope="module")
def results(inputs):
    out, _ = inputs
    run_ranks("misc", out, timeout=300)
    return torch.load(out / "misc_out.pt", weights_only=False)


@pytest.mark.parametrize("rank", range(4))
def test_compressed_psum_pod_is_the_mean_of_dequantised_parts(inputs,
                                                              results, rank):
    """Mesh (pod 2, data 2): rank r's pod group is {r % 2, r % 2 + 2}.
    The mean equals the mean of the reference's ``_deq(_q(g + e))`` of
    the group's members; the residual matches bit for bit."""
    out, payload = inputs
    got = torch.load(out / f"compress_{rank}.pt", weights_only=False)
    members = [rank % 2, rank % 2 + 2]
    for k, shape in GRAD_SHAPES.items():
        parts = []
        for r in members:
            gf = jnp.asarray(payload["grads"][k][r]) \
                + jnp.asarray(payload["residual"][k][r])
            deq = jax_comp._deq(*jax_comp._q(gf), gf.shape)
            parts.append(deq)
            if r == rank:
                np.testing.assert_array_equal(got["residual"][k],
                                              np.asarray(gf - deq))
        want = np.asarray(jnp.mean(jnp.stack(parts), axis=0))
        np.testing.assert_allclose(got["mean"][k], want, rtol=1e-7,
                                   atol=1e-7)


def test_collective_tally_is_the_same_in_two_steps(results):
    first, second = (s["tally"] for s in results["tally"]["steps"])
    assert first == second
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert first[kind]["count"] > 0, kind
    assert first["all-to-all"]["count"] == 0


def test_a_parameters_all_gather_bytes_equal_its_bytes(results):
    """Under FSDP on (2, 2) the final norm's scale (``embed`` over data)
    is gathered whole, and the gate's block (``mlp`` over model) is
    gathered over data into the rank's whole column block."""
    tally = results["tally"]
    calls = tally["steps"][0]["calls"]
    gathers = [c for c in calls if c["kind"] == "all-gather"]
    for name, model_parts in (("ln_f", 1), ("blocks.0.mlp.gate", 2)):
        local, full = tally["local"][name], tally["global"][name]
        want = int(np.prod(full)) * 4 // model_parts
        assert any(c["operand_shape"] == local and c["result_bytes"] == want
                   for c in gathers), name


def test_analysis_has_the_reference_keys(results):
    mine = analyze_collectives(results["tally"]["steps"][0]["tally"])
    ref = ref_analyze("")
    assert set(mine) == set(ref) and set(mine["per_op"]) == \
        set(ref["per_op"])
    assert mine["collective_bytes"] == max(
        mine["collective_operand_bytes"], mine["collective_result_bytes"])


def test_adamw_state_carried_onto_the_mesh(inputs, results):
    _, payload = inputs
    cfg = reduce_config(ARCHS[ARCH], **OVER)
    whole = adamw_state_from_numpy(payload["state"], cfg, "cpu")
    for n, mv in whole["mu"].items():
        for k in ("m", "v"):
            np.testing.assert_array_equal(results["adamw_state"][n][k],
                                          mv[k].numpy(), err_msg=n)


def test_checkpoint_saved_at_2x2_restores_at_4x1(results):
    saved, restored = results["saved"], results["restored"]
    assert restored["count"] == saved["count"] == 2
    assert restored["data_state"] == {"epoch": 0, "index": 16}
    for part in ("params", "m"):
        for n, v in saved[part].items():
            np.testing.assert_array_equal(restored[part][n], v, err_msg=n)


def test_checkpoint_saved_at_2x2_restores_on_one_rank(inputs, results):
    out, _ = inputs
    cfg = reduce_config(ARCHS[ARCH], **OVER)
    params = build_model(cfg).init(5, device="cpu", trainable=True)
    named = dict(params.named_parameters())
    state = make_optimizer("adamw").init(named)
    mgr = CheckpointManager(str(out / "ckpt"))
    mgr.restore(mgr.latest_step(), (named, state))
    for n, p in named.items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      results["saved"]["params"][n])
        np.testing.assert_array_equal(state["mu"][n]["m"].numpy(),
                                      results["saved"]["m"][n])
    assert int(state["count"]) == results["saved"]["count"]
