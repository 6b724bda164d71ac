"""The port's GPipe pipeline on 4 gloo ranks against the reference.

The forward equals the reference's own ``pipeline_apply`` on 4 host
devices (run in a child process with
``--xla_force_host_platform_device_count``, as ``tests/
test_distribution.py`` runs it); the gradient of ``pipeline_loss`` equals
the reference's sequential ``jax.grad`` (rtol 1e-4, atol 1e-5, as
``test_distribution.py`` holds its own pipeline).  Each rank is one stage
of ``tanh(x @ w_s)``."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.train.pipeline import (bubble_fraction,  # noqa: E402
                                        split_microbatches)
from torch_dist_util import ROOT, run_ranks  # noqa: E402

# the module's ranks start once, in its module fixture: under any xdist
# mode that splits a file (``--dist loadgroup``) its tests stay together
pytestmark = pytest.mark.xdist_group("pipeline")

S, M, B, D = 4, 8, 16, 16          # the forward: 8 micro-batches of 16
MG, BG = 4, 8                      # the gradient: 4 micro-batches of 8


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    np.savez(out / "pipe_in.npz",
             ws=(rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
             x=rng.standard_normal((M * B, D)).astype(np.float32),
             xg=rng.standard_normal((MG * BG, D)).astype(np.float32),
             tg=rng.standard_normal((MG * BG, D)).astype(np.float32),
             M=M, Mg=MG)
    return out


@pytest.fixture(scope="module")
def port(inputs):
    run_ranks("pipeline", inputs, world=S, timeout=180)
    return np.load(inputs / "pipe_out.npz")


@pytest.fixture(scope="module")
def reference_forward(inputs):
    """The reference's ``pipeline_apply`` on a 4-device stage mesh."""
    script = textwrap.dedent(f"""
        import jax, numpy as np
        from repro.train.pipeline import pipeline_apply, split_microbatches
        inp = np.load({str(inputs / 'pipe_in.npz')!r})
        mesh = jax.make_mesh(({S},), ("stage",))
        xs = split_microbatches(jax.numpy.asarray(inp["x"]), {M})
        with mesh:
            out = pipeline_apply(lambda p, x: jax.numpy.tanh(x @ p["w"]),
                                 {{"w": jax.numpy.asarray(inp["ws"])}}, xs,
                                 mesh=mesh, axis="stage")
        np.save({str(inputs / 'ref_out.npy')!r}, np.asarray(out))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          f" --xla_force_host_platform_device_count={S}"))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return np.load(inputs / "ref_out.npy")


def test_pipeline_forward_equals_the_references_pipeline(port,
                                                         reference_forward):
    np.testing.assert_allclose(port["out"], reference_forward, rtol=2e-5,
                               atol=2e-5)


def test_pipeline_forward_is_the_sequential_stack(port, inputs):
    inp = np.load(inputs / "pipe_in.npz")
    y = inp["x"]
    for w in inp["ws"]:
        y = np.tanh(y @ w)
    np.testing.assert_allclose(port["out"].reshape(M * B, D), y, rtol=2e-5,
                               atol=2e-5)


def test_pipeline_gradients_equal_the_sequential_grad(port, inputs):
    inp = np.load(inputs / "pipe_in.npz")
    x, t = jnp.asarray(inp["xg"]), jnp.asarray(inp["tg"])

    def seq_loss(ws):
        y = x
        for i in range(S):
            y = jnp.tanh(y @ ws[i])
        return jnp.mean(jax.vmap(lambda a, b: jnp.mean((a - b) ** 2))(
            y.reshape(MG, BG, D), t.reshape(MG, BG, D)))

    loss, grads = jax.value_and_grad(seq_loss)(jnp.asarray(inp["ws"]))
    np.testing.assert_allclose(port["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(port["grads"], np.asarray(grads), rtol=1e-4,
                               atol=1e-5)


def test_bubble_fraction_and_micro_batches():
    assert abs(bubble_fraction(4, 8) - 3 / 11) < 1e-12
    x = torch.arange(24.).reshape(12, 2)
    assert split_microbatches(x, 3).shape == (3, 4, 2)
    with pytest.raises(ValueError, match="micro-batches"):
        split_microbatches(x, 5)
