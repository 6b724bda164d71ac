"""In-place activation calculus (NNTrainer §3, Fig. 1(c) "InplaceOp").

The paper's key observation: for sigmoid, ``dX = dY * Y * (1 - Y)`` — the
derivative needs the *output*, not the input.  Storing only the output (and
letting the input's buffer be reused) halves intermediate-activation memory
for the conv->act / linear->act pattern that dominates real models.

Each activation here provides:
  * ``fwd(x)``            — forward
  * ``deriv_from_out(y)`` — d(act)/dx expressed in terms of y = act(x)

:func:`apply_activation_` computes the activation into its input's own
storage: the replay backends call it where the execution-order analysis
merged the activation's output into its input (an ``MV`` view), so the two
names share one buffer on the card, as they share one arena slot in the
plan.  ``make_inplace_act(fn)`` wraps the pair in a
``torch.autograd.Function`` whose saved tensor is the OUTPUT, the autograd
counterpart of the reference's ``jax.custom_vjp``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _sigmoid_deriv(y):
    return y * (1.0 - y)


def _tanh_deriv(y):
    return 1.0 - y * y


def _relu_deriv(y):
    # y > 0 exactly where x > 0 (ties at 0 have zero derivative anyway)
    return (y > 0.0).to(y.dtype)


def _softmax_vjp_from_out(y, dy):
    # dX = y * (dy - sum(dy * y, axis=-1, keepdims=True))
    return y * (dy - torch.sum(dy * y, dim=-1, keepdim=True))


_ELEMENTWISE: Dict[str, Tuple[Callable, Callable, Callable]] = {
    # fn -> (forward, forward into the input's storage, deriv from output)
    "sigmoid": (torch.sigmoid, torch.sigmoid_, _sigmoid_deriv),
    "tanh": (torch.tanh, torch.tanh_, _tanh_deriv),
    "relu": (torch.relu, torch.relu_, _relu_deriv),
}


def deriv_from_output(fn: str, y, dy):
    """dLoss/dX given the activation *output* y and upstream derivative dy."""
    if fn == "softmax":
        return _softmax_vjp_from_out(y, dy)
    return dy * _ELEMENTWISE[fn][2](y)


def apply_activation(fn: str, x):
    if fn == "softmax":
        return torch.softmax(x, dim=-1)
    return _ELEMENTWISE[fn][0](x)


def apply_activation_(fn: str, x):
    """The activation computed into ``x``'s storage; returns ``x``."""
    if fn == "softmax":
        return x.copy_(torch.softmax(x, dim=-1))
    return _ELEMENTWISE[fn][1](x)


def make_inplace_act(fn: str):
    """An activation whose saved tensor is its OUTPUT (not input), so the
    input's buffer is free after the forward — NNTrainer's MV merge."""

    class _Act(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            y = apply_activation(fn, x)
            ctx.save_for_backward(y)      # residual = output only
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensors
            return deriv_from_output(fn, y, dy)

    _Act.__name__ = f"InplaceAct_{fn}"
    return _Act.apply


# Ready-made in-place activations.
sigmoid = make_inplace_act("sigmoid")
tanh = make_inplace_act("tanh")
relu = make_inplace_act("relu")
softmax = make_inplace_act("softmax")


def bn_stats(x, eps=1e-5):
    """Batch mean and ``rsqrt(var + eps)`` over axis 0 (biased variance)."""
    mean = torch.mean(x, dim=0, keepdim=True)
    var = torch.var(x, dim=0, keepdim=True, unbiased=False)
    return mean, torch.rsqrt(var + eps)


def bn_deriv_from_output(y, gamma, beta, inv_std, dy):
    """(dx, dgamma, dbeta) of batch-norm from its OUTPUT ``y``.

    For y = gamma * xhat + beta, xhat = (y - beta) / gamma and x is never
    needed:
        dxhat = dy * gamma
        dx    = (1/N) * inv_std * (N*dxhat - sum(dxhat) - xhat*sum(dxhat*xhat))
        dgamma = sum(dy * xhat); dbeta = sum(dy)
    """
    n = y.shape[0]
    xhat = (y - beta) / torch.where(gamma == 0, torch.ones_like(gamma), gamma)
    dxhat = dy * gamma
    s1 = torch.sum(dxhat, dim=0, keepdim=True)
    s2 = torch.sum(dxhat * xhat, dim=0, keepdim=True)
    dx = (inv_std / n) * (n * dxhat - s1 - xhat * s2)
    return dx, torch.sum(dy * xhat, dim=0), torch.sum(dy, dim=0)


class _BatchNorm(torch.autograd.Function):
    """Batch-norm whose backward uses the normalised output (paper §3:
    'this is applied to batch normalization as well').  Saved tensors:
    output y, gamma, beta, inv_std — all O(C) except y (which is the tensor
    the in-place merge shares with the input)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps=1e-5):
        mean, inv_std = bn_stats(x, eps)
        y = gamma * (x - mean) * inv_std + beta
        ctx.save_for_backward(y, gamma, beta, inv_std)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dgamma, dbeta = bn_deriv_from_output(*ctx.saved_tensors, dy)
        return dx, dgamma, dbeta, None


def batchnorm(x, gamma, beta, eps=1e-5):
    return _BatchNorm.apply(x, gamma, beta, eps)
