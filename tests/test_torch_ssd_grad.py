"""The SSD and mLSTM scans' gradients against the JAX package.

``ssd_scan`` and ``mlstm_scan`` run as autograd Functions when a gradient
is needed: the forward is the kernel (its plain twin on the CPU), the
backward the vjp of ``models.ssm.ssd_chunked`` / ``models.xlstm.
mlstm_chunked``, the ports of the jnp functions the reference
differentiates.  Held here, on numpy inputs from a seed:

* each port function against its jnp counterpart, forward and vjp;
* each scan's grads against ``jax.grad`` of the reference's jnp function,
  at the SSD probe's inputs (b 1, h 4, p = n = 16, dt in [0, 2), A_log =
  log(linspace(1, 16))) at s = 256 and at a ragged s = 300, and for
  mLSTM at the same lengths, plus tied row maxima;
* why the twin is not differentiated: its backward is not finite.

Tolerance: every gradient normwise within 1e-4 of the reference's (the
largest error over the largest value), forwards elementwise 1e-4.  The
SSD cases sum the port's cumsums in the reference's float32 order
(``xla_cumsum``, the ``reference_order`` fixture): the port sums them in
float64, as its kernels do, and at the probe's log decays, which reach
hundreds in a 256-row chunk, two float32 orders of the same sums move
``ssd_chunked``'s output and its dt grad by more than 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import layers, ssm, xlstm  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
CUMSUM_BLOCK = 16


def xla_cumsum(x, dim):
    """``jnp.cumsum`` in the order XLA sums it on the CPU: a prefix summed
    one element at a time within blocks of 16, the blocks' totals prefixed
    the same way (recursively) and added to each block (XLA rewrites the
    cumsum's reduce-window in two levels), in ``x``'s dtype."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    pad = -n % CUMSUM_BLOCK
    blocks = torch.nn.functional.pad(x, (0, pad)).unflatten(
        -1, (-1, CUMSUM_BLOCK))
    acc, pre = blocks[..., 0], [blocks[..., 0]]
    for i in range(1, CUMSUM_BLOCK):
        acc = acc + blocks[..., i]
        pre.append(acc)
    pre = torch.stack(pre, dim=-1)                       # in-block prefixes
    if blocks.shape[-2] > 1:
        totals = xla_cumsum(pre[..., -1], -1)
        pre = pre + torch.nn.functional.pad(totals[..., :-1],
                                            (1, 0))[..., None]
    return pre.flatten(-2)[..., :n].movedim(-1, dim)


@pytest.fixture
def reference_order(monkeypatch):
    """The port's cumsums (``layers.cumsum``) in the reference's float32
    order instead of float64."""
    monkeypatch.setattr(layers, "cumsum", xla_cumsum)


def _rel(got, want):
    """Normwise error; the absolute one where the reference is all zero
    (the forget gate's grad at a saturated gate)."""
    got, want = got.detach().numpy(), np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale else 1.0))


def _ssd_inputs(s, seed=0, b=1, h=4, p=16, n=16):
    """The probe's inputs: dt in [0, 2), A_log = log(linspace(1, 16))."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.0, 2.0, (b, s, h)).astype(np.float32),
            np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, h, p)).astype(np.float32))


def _mlstm_inputs(s, seed=0, b=1, h=4, p=32, ties=False):
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.standard_normal((b, s, h, p)).astype(np.float32)
                   for _ in range(4))
    if ties:
        # lf = log_sigmoid(200) is 0 in float32 and the input gate is one
        # value: every entry of a row of the decay matrix ties
        ig = np.full((b, s, h), 0.5, np.float32)
        fg = np.full((b, s, h), 200.0, np.float32)
    else:
        ig = rng.standard_normal((b, s, h)).astype(np.float32)
        fg = (rng.standard_normal((b, s, h)) + 3.0).astype(np.float32)
    return q, k, v, ig, fg, dy


def _jax_vjp(fn, args, dy):
    y, pull = jax.vjp(fn, *map(jnp.asarray, args))
    return np.asarray(y), [np.asarray(g) for g in pull(jnp.asarray(dy))]


def _torch_vjp(fn, args, dy):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    return y.detach(), grads


@pytest.mark.parametrize("s", [256, 300])
def test_ssd_scan_grads_are_finite_and_match_jax(s, reference_order):
    """``ssd_scan`` (the twin's forward, ``ssd_chunked``'s vjp) against
    ``jax.grad`` of the reference's ``ssd_chunked``: all five grads finite
    and within 1e-4 normwise."""
    *args, dy = _ssd_inputs(s)
    _, want = _jax_vjp(jssm.ssd_chunked, args, dy)
    _, got = _torch_vjp(ssd_ops.ssd_scan, args, dy)
    for name, g, w in zip(("x", "dt", "A_log", "B", "C"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("s", [64, 256, 300])
def test_ssd_chunked_matches_jnp(s, reference_order):
    """``models.ssm.ssd_chunked`` against the reference's: forward and
    every input's vjp."""
    *args, dy = _ssd_inputs(s, seed=1)
    y_want, want = _jax_vjp(jssm.ssd_chunked, args, dy)
    y, got = _torch_vjp(ssm.ssd_chunked, args, dy)
    np.testing.assert_allclose(y.numpy(), y_want, rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_the_ssd_twin_is_a_forward_oracle():
    """Differentiating the kernel's plain twin gives NaN for dt and A_log
    (its L selects after the exp, and 0 * inf = NaN above the diagonal),
    which is why ``ssd_scan``'s backward recomputes ``ssd_chunked``."""
    *args, dy = _ssd_inputs(256)
    _, got = _torch_vjp(lambda *a: ssd_ops._forward(*a, 256), args, dy)
    finite = [bool(torch.isfinite(g).all()) for g in got]
    assert finite == [True, False, False, True, True]


@pytest.mark.parametrize("s,ties", [(256, False), (300, False),
                                    (300, True)])
def test_mlstm_scan_grads_match_jax(s, ties):
    """``mlstm_scan`` (the twin's forward, ``mlstm_chunked``'s vjp) against
    ``jax.grad`` of the reference's ``mlstm_chunked``; with tied row
    maxima too, where ``amax`` splits the gradient as JAX's max does."""
    *args, dy = _mlstm_inputs(s, ties=ties)
    _, want = _jax_vjp(jxlstm.mlstm_chunked, args, dy)
    _, got = _torch_vjp(mlstm_ops.mlstm_scan, args, dy)
    for name, g, w in zip(("q", "k", "v", "i_gate", "f_gate"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("s", [64, 300])
def test_mlstm_chunked_matches_jnp(s):
    """``models.xlstm.mlstm_chunked`` against the reference's: forward and
    every input's vjp."""
    *args, dy = _mlstm_inputs(s, seed=1)
    y_want, want = _jax_vjp(jxlstm.mlstm_chunked, args, dy)
    y, got = _torch_vjp(xlstm.mlstm_chunked, args, dy)
    np.testing.assert_allclose(y.numpy(), y_want, rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("scan,make", [
    (ssd_ops.ssd_scan, lambda: _ssd_inputs(64)[:5]),
    (mlstm_ops.mlstm_scan, lambda: _mlstm_inputs(64)[:5])])
def test_the_function_runs_only_under_autograd(scan, make):
    """Outside autograd the scan runs bare (serving); under it the
    Function records one node whose backward needs only its inputs, and
    only the inputs that need a gradient get one."""
    args = [torch.from_numpy(np.array(a)) for a in make()]
    with torch.no_grad():
        bare = scan(*args)
    assert bare.grad_fn is None
    args[0].requires_grad_()
    y = scan(*args)
    assert type(y.grad_fn).__name__.endswith("ScanBackward")
    torch.testing.assert_close(y.detach(), bare, rtol=0, atol=0)
    y.sum().backward()
    assert args[0].grad is not None
    assert all(a.grad is None for a in args[1:])
