"""Port parity of the per-layer math of the paper's path: every layer kind's
Forward / Compute-Gradient / Compute-Derivative, both losses with and
without a sample mask, the in-place activation and batch-norm calculus,
and then the plain layer-basis walk and the ``torch.autograd`` reference on
every zoo graph, against the reference's ``jax.grad`` on the same numpy
inputs and parameters (loss rtol 1e-5; grads rtol 1e-4, atol 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import inplace as jinplace  # noqa: E402
from repro.core import zoo as jzoo  # noqa: E402
from repro.core.exec import layers as jl  # noqa: E402
from repro.core.graph import LayerNode as JNode  # noqa: E402
from repro.core.graph import infer_shapes as j_infer  # noqa: E402
from repro_torch.convert import graph_params_from_numpy  # noqa: E402
from repro_torch.core import inplace as tinplace  # noqa: E402
from repro_torch.core import zoo as tzoo  # noqa: E402
from repro_torch.core.exec import layers as tl  # noqa: E402
from repro_torch.core.graph import LayerNode as TNode  # noqa: E402
from repro_torch.core.graph import infer_shapes as t_infer  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _shrink(graph, infer):
    """The zoo's 150528-wide inputs cut to 96 (the reference tests' own
    shrink), so the CPU runs in seconds."""
    for l in graph.layers:
        if l.attrs.get("in_features") == 150528:
            l.attrs["in_features"] = 96
    if graph.input_shape == (150528,):
        object.__setattr__(graph, "input_shape", (96,))
    infer(graph)
    return graph


# ---------------------------------------------------------------------------
# Layer kinds: (kind, attrs, input shapes, param shapes)
# ---------------------------------------------------------------------------

LAYER_CASES = {
    "linear": ("linear", {"in_features": 6, "out_features": 5},
               [(3, 6)], {"w": (6, 5), "b": (5,)}),
    "linear_3d": ("linear", {"in_features": 6, "out_features": 5,
                             "bias": False},
                  [(3, 2, 6)], {"w": (6, 5)}),
    # stride 2, SAME, even input: lax pads (0, 1), torch's padding=1 (1, 1)
    "conv_s2_same_even": ("conv2d", {"in_ch": 3, "out_ch": 4, "ksize": 3,
                                     "stride": 2, "padding": "same"},
                          [(2, 3, 8, 8)], {"w": (4, 3, 3, 3), "b": (4,)}),
    "conv_s2_same_odd": ("conv2d", {"in_ch": 3, "out_ch": 2, "ksize": 3,
                                    "stride": 2, "padding": "same",
                                    "bias": False},
                         [(2, 3, 7, 9)], {"w": (2, 3, 3, 3)}),
    "conv_s1_same_k5": ("conv2d", {"in_ch": 2, "out_ch": 3, "ksize": 5,
                                   "stride": 1, "padding": "same"},
                        [(2, 2, 6, 6)], {"w": (3, 2, 5, 5), "b": (3,)}),
    "conv_s1_same_k4": ("conv2d", {"in_ch": 2, "out_ch": 3, "ksize": 4,
                                   "stride": 1, "padding": "same",
                                   "bias": False},
                        [(2, 2, 6, 6)], {"w": (3, 2, 4, 4)}),
    "conv_valid": ("conv2d", {"in_ch": 2, "out_ch": 3, "ksize": 5,
                              "stride": 1, "padding": "valid"},
                   [(2, 2, 9, 9)], {"w": (3, 2, 5, 5), "b": (3,)}),
    "conv_1x1_s2": ("conv2d", {"in_ch": 4, "out_ch": 2, "ksize": 1,
                               "stride": 2, "padding": "same"},
                    [(2, 4, 8, 8)], {"w": (2, 4, 1, 1), "b": (2,)}),
    "sigmoid": ("activation", {"fn": "sigmoid"}, [(3, 7)], {}),
    "tanh": ("activation", {"fn": "tanh"}, [(3, 7)], {}),
    "relu": ("activation", {"fn": "relu"}, [(2, 3, 4, 4)], {}),
    "softmax": ("activation", {"fn": "softmax"}, [(3, 7)], {}),
    "batchnorm": ("batchnorm", {"channels": 6}, [(5, 6)],
                  {"gamma": (6,), "beta": (6,)}),
    "flatten": ("flatten", {}, [(2, 3, 4, 4)], {}),
    "reshape": ("reshape", {"out_shape": (4, 12)}, [(2, 3, 4, 4)], {}),
    "pool_k2": ("pool2d", {"ksize": 2, "stride": 2}, [(2, 3, 8, 8)], {}),
    "pool_k3_s2": ("pool2d", {"ksize": 3, "stride": 2}, [(2, 3, 7, 7)], {}),
    "add": ("add", {}, [(3, 5), (3, 5), (3, 5)], {}),
    "concat": ("concat", {"axis": -1}, [(3, 2), (3, 5)], {}),
    "multiout": ("multiout", {}, [(3, 5)], {}),
    "embedding": ("embedding", {"vocab": 11, "dim": 4}, [(6, 1)],
                  {"w": (11, 4)}),
    "lstm": ("lstm", {"in_features": 5, "hidden": 3}, [(4, 5)],
             {"wx": (5, 12), "wh": (3, 12), "b": (12,)}),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_forward_gradient_derivative(case):
    kind, attrs, in_shapes, p_shapes = LAYER_CASES[case]
    r = np.random.default_rng(sum(map(ord, case)))
    if kind == "embedding":
        xs = [r.integers(0, attrs["vocab"], s).astype(np.float32)
              for s in in_shapes]
    else:
        xs = [r.standard_normal(s).astype(np.float32) for s in in_shapes]
    ps = {k: (r.standard_normal(s) * 0.5 + (1.0 if k == "gamma" else 0.0))
          .astype(np.float32) for k, s in p_shapes.items()}
    inputs = [f"in{i}" for i in range(len(xs))]
    jnode = JNode("l", kind, inputs, dict(attrs))
    tnode = TNode("l", kind, inputs, dict(attrs))
    jp = {k: jnp.asarray(v) for k, v in ps.items()} or None
    tp = {k: torch.from_numpy(v) for k, v in ps.items()} or None

    jy, jctx = jl.layer_forward(jnode, [jnp.asarray(x) for x in xs], jp)
    ty, tctx = tl.layer_forward(tnode, [torch.from_numpy(x) for x in xs], tp)
    _close(ty, jy)
    dy = r.standard_normal(np.shape(jy)).astype(np.float32)
    if jp is not None:
        jg = jl.layer_calc_gradient(jnode, jctx, jnp.asarray(dy), jp)
        tg = tl.layer_calc_gradient(tnode, tctx, torch.from_numpy(dy), tp)
        assert sorted(tg) == sorted(jg)
        for k in jg:
            _close(tg[k], jg[k])
    jdx = jl.layer_calc_derivative(jnode, jctx, jnp.asarray(dy), jp)
    tdx = tl.layer_calc_derivative(tnode, tctx, torch.from_numpy(dy), tp)
    assert len(tdx) == len(jdx)
    for a, b in zip(tdx, jdx):
        _close(a, b)


def test_stride2_same_padding_is_lax_not_symmetric():
    """The trap the explicit padding exists for: on an even input,
    ``F.conv2d(padding=1)`` gives lax's shape but not its values."""
    r = np.random.default_rng(3)
    x = r.standard_normal((1, 2, 8, 8)).astype(np.float32)
    w = r.standard_normal((3, 2, 3, 3)).astype(np.float32)
    want = jl._conv2d_fwd(jnp.asarray(x), jnp.asarray(w), None, 2, "same")
    got = tl._conv2d_fwd(torch.from_numpy(x), torch.from_numpy(w), None, 2,
                         "same")
    naive = torch.nn.functional.conv2d(torch.from_numpy(x),
                                       torch.from_numpy(w), stride=2,
                                       padding=1)
    _close(got, want)
    assert naive.shape == got.shape
    assert not np.allclose(_np(naive), _np(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fn", ["sigmoid", "tanh", "relu", "softmax"])
def test_inplace_activation_calculus(fn):
    r = np.random.default_rng(4)
    x = r.standard_normal((4, 6)).astype(np.float32)
    dy = r.standard_normal((4, 6)).astype(np.float32)
    jy, jvjp = jax.vjp(getattr(jinplace, fn), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = getattr(tinplace, fn)(tx)
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(dy))
    _close(ty, jy)
    _close(tdx, jvjp(jnp.asarray(dy))[0])
    # in place: the activation lands in the input's own storage
    buf = torch.from_numpy(x.copy())
    out = tinplace.apply_activation_(fn, buf)
    assert out.data_ptr() == buf.data_ptr()
    _close(out, jy)


def test_inplace_batchnorm_calculus():
    r = np.random.default_rng(5)
    x = r.standard_normal((6, 4)).astype(np.float32)
    gamma = (r.standard_normal(4) + 1.0).astype(np.float32)
    beta = r.standard_normal(4).astype(np.float32)
    dy = r.standard_normal((6, 4)).astype(np.float32)
    jy, jvjp = jax.vjp(jinplace.batchnorm, jnp.asarray(x), jnp.asarray(gamma),
                       jnp.asarray(beta))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta)]
    ty = tinplace.batchnorm(*tin)
    tgrads = torch.autograd.grad(ty, tin, torch.from_numpy(dy))
    _close(ty, jy)
    for a, b in zip(tgrads, jvjp(jnp.asarray(dy))):
        _close(a, b)


@pytest.mark.parametrize("kind", ["loss_mse", "loss_ce"])
@pytest.mark.parametrize("masked", [False, True])
def test_losses(kind, masked):
    r = np.random.default_rng(6)
    pred = r.standard_normal((5, 7)).astype(np.float32)
    label = r.standard_normal((5, 7)).astype(np.float32)
    if kind == "loss_ce":
        label = np.eye(7, dtype=np.float32)[r.integers(0, 7, 5)]
    mask = np.array([1, 0, 1, 1, 0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    args = (jnp.asarray(pred), jnp.asarray(label))
    targs = (torch.from_numpy(pred), torch.from_numpy(label))
    _close(tl.loss_forward(kind, *targs, tm), jl.loss_forward(kind, *args, jm),
           rtol=1e-5, atol=1e-6)
    _close(tl.loss_derivative(kind, *targs, tm),
           jl.loss_derivative(kind, *args, jm))


# ---------------------------------------------------------------------------
# Whole graphs: the plain walk and the autograd reference vs jax.grad
# ---------------------------------------------------------------------------

def _graph_case(name, batch=2):
    """(reference graph, port graph, numpy params, x, label)."""
    jg = _shrink(jzoo.ZOO[name](), j_infer)
    tg = _shrink(tzoo.ZOO[name](), t_infer)
    params = jax.tree_util.tree_map(
        np.asarray, jl.init_params(jg, jax.random.PRNGKey(0)))
    r = np.random.default_rng(7)
    if any(l.kind == "embedding" for l in jg.layers):
        x = r.integers(0, 50, (batch,) + tuple(jg.input_shape)) \
            .astype(np.int32)
    else:
        x = r.standard_normal((batch,) + tuple(jg.input_shape)) \
            .astype(np.float32)
    y = r.standard_normal((batch,) + tuple(jg.label_shape)).astype(np.float32)
    if jg.layers[-1].kind == "loss_ce":
        y = np.eye(y.shape[-1], dtype=np.float32)[np.argmax(y, -1)]
    return jg, tg, params, x, y


def _assert_grads(got, want):
    """rtol 1e-4 with atol 1e-5 per unit of the tensor's largest entry:
    torch's and XLA's CPU convolutions sum in different orders, which moves
    near-zero entries of a large weight gradient (resnet18's reach 8) by up
    to ~3e-6 of that scale."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), k
        for n in want[k]:
            scale = max(1.0, float(np.abs(np.asarray(want[k][n])).max(
                initial=0.0)))
            _close(got[k][n], want[k][n], rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("name", sorted(tzoo.ZOO))
def test_zoo_grads_match_jax_grad(name):
    jg, tg, params, x, y = _graph_case(name)
    jloss, jgrads = jl.reference_loss_and_grads(
        jg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(y))
    tp = graph_params_from_numpy(params, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for fn in (tl.reference_loss_and_grads, tl.planned_loss_and_grads):
        loss, grads = fn(tg, tp, tx, ty)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _assert_grads(grads, jgrads)


def test_masked_walk_matches_jax_grad():
    jg, tg, params, x, y = _graph_case("model_c_linear", batch=4)
    mask = np.array([1, 1, 0, 1], np.float32)
    jloss, jgrads = jl.reference_loss_and_grads(
        jg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(mask))
    tp = graph_params_from_numpy(params, device="cpu")
    for fn in (tl.reference_loss_and_grads, tl.planned_loss_and_grads):
        loss, grads = fn(tg, tp, torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(mask))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        _assert_grads(grads, jgrads)


def test_sgd_update_and_init():
    g = tzoo.ZOO["model_a_linear"]()
    p = tl.init_params(g, torch.Generator().manual_seed(0), device="cpu")
    again = tl.init_params(g, torch.Generator().manual_seed(0), device="cpu")
    for k in p:
        for n in p[k]:
            assert torch.equal(p[k][n], again[k][n])
            assert tuple(p[k][n].shape) == \
                g.layer(k).weight_shapes()[n]
    grads = {k: {n: torch.ones_like(w) for n, w in v.items()}
             for k, v in p.items()}
    new = tl.sgd_update(p, grads, lr=0.5)
    for k in p:
        for n in p[k]:
            assert torch.equal(new[k][n], p[k][n] - 0.5)
