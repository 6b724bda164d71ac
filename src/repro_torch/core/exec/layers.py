"""Pure per-layer forward / backward math (NNTrainer §3, Figure 2(b)).

The layer-operation basis decomposes training into per-layer Forward,
Compute-Gradient and Compute-Derivative callables; this module holds that
math and nothing else — no stores, no swap scheduling, no backends.  The
saved context of each layer honours the lifespan analysis: weighted layers
save inputs (F+CG), in-place activations save only their OUTPUT (F+CD),
views save nothing.

Also here: the plain (no-swap) layer-basis walk
:func:`planned_loss_and_grads` and the whole-graph ``torch.autograd``
reference (:func:`reference_loss_and_grads`) every executor backend is
validated against — the paper's own CI gate ("if a weight or activation
value has an error over 1e-4 the commit is rejected").

Layouts follow the reference: conv2d is NCHW with OIHW weights, linear
weights are (in, out), lstm gates are ordered i, f, g, o.  ``"same"``
padding is lax's: for stride 2 on an even input the extra row and column
go on the high side, which ``F.conv2d(padding=1)`` would get wrong, so the
input is padded explicitly (low = total // 2, high = the rest).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import inplace
from repro_torch.core.graph import (WEIGHTED_KINDS, LayerGraph, LayerNode,
                                    _has_trainable_upstream)
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
Params = Dict[str, Dict[str, Tensor]]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_params(graph: LayerGraph, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """He-init weights for every weighted layer; E-shared layers reuse the
    first unrolled copy's parameters (Tensor-sharing, CreateMode.EXTEND).

    Draws come from ``generator`` (on its own device) and land on
    ``device``: the CUDA card when None (raises without one)."""
    dev = resolve_device(device)
    params: Params = {}
    for l in graph.layers:
        if l.shares_weights_with:
            continue  # storage owned by the first copy
        shapes = l.weight_shapes()
        if not shapes:
            continue
        entry = {}
        for wname, shape in shapes.items():
            if wname in ("b", "beta"):
                entry[wname] = torch.zeros(shape, dtype=dtype, device=dev)
            elif wname in ("gamma",):
                entry[wname] = torch.ones(shape, dtype=dtype, device=dev)
            else:
                fan_in = shape[0]
                if l.kind in ("conv2d", "conv1d"):
                    fan_in = math.prod(shape[1:])
                scale = math.sqrt(2.0 / max(fan_in, 1))
                w = torch.randn(shape, generator=generator, dtype=dtype,
                                device=generator.device)
                entry[wname] = (w * scale).to(dev)
        params[l.name] = entry
    return params


def _param_owner(graph: LayerGraph, l: LayerNode) -> str:
    return l.shares_weights_with or l.name


# ---------------------------------------------------------------------------
# Per-layer forward / backward (layer basis: F, CG, CD as separate callables)
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """lax ``"SAME"`` padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_pads(x, k: int, stride: int, padding: str):
    """(low H, high H, low W, high W) padding of lax's ``padding``."""
    if padding.upper() == "VALID":
        return 0, 0, 0, 0
    if padding.upper() != "SAME":
        raise ValueError(f"conv2d padding {padding!r}: use same or valid")
    return (_same_pads(x.shape[2], k, stride)
            + _same_pads(x.shape[3], k, stride))


def _conv_pad(x, k: int, stride: int, padding: str):
    """``x`` padded for a VALID conv that computes lax's ``padding``."""
    hl, hh, wl, wh = _conv_pads(x, k, stride, padding)
    return F.pad(x, (wl, wh, hl, hh)) if hl + hh + wl + wh else x


def _conv2d_fwd(x, w, b, stride, padding):
    # x: (B, C, H, W), w: (O, I, K, K)
    y = F.conv2d(_conv_pad(x, w.shape[-1], stride, padding), w,
                 stride=stride)
    if b is not None:
        y = y + b[None, :, None, None]
    return y


def _pool2d_fwd(x, ksize, stride):
    return F.max_pool2d(x, ksize, stride)     # VALID windows


def _lstm_cell(x, h, c, wx, wh, b):
    gates = x @ wx + h @ wh + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def _vjp(fn, primals, dy):
    """Gradients of ``fn(*primals)`` against ``dy`` (the reference's
    ``jax.vjp`` at the same point)."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in primals]
        return torch.autograd.grad(fn(*leaves), leaves, dy)


def layer_forward(l: LayerNode, xs: List[Tensor],
                  p: Optional[Dict[str, Tensor]],
                  state: Optional[Dict[str, Tensor]] = None
                  ) -> Tuple[Tensor, Any]:
    """Forward one layer; returns (output, saved-context for backward).

    The saved context honours the lifespan analysis: weighted layers save
    inputs (F+CG), in-place activations save only their OUTPUT (F+CD),
    views save nothing.
    """
    a = l.attrs
    x = xs[0]
    if l.kind == "linear":
        y = x @ p["w"]
        if "b" in p:
            y = y + p["b"]
        return y, (x,)
    if l.kind == "conv2d":
        y = _conv2d_fwd(x, p["w"], p.get("b"), a.get("stride", 1),
                        a.get("padding", "same"))
        return y, (x,)
    if l.kind == "activation":
        y = inplace.apply_activation(a["fn"], x)
        return y, (y,)     # output-only residual: the in-place property
    if l.kind == "batchnorm":
        mean, inv_std = inplace.bn_stats(x)
        y = p["gamma"] * (x - mean) * inv_std + p["beta"]
        return y, (y, inv_std)   # output-based residual (paper §3)
    if l.kind == "flatten":
        return x.reshape(x.shape[0], -1), (x.shape,)
    if l.kind == "reshape":
        return x.reshape((x.shape[0],) + tuple(a["out_shape"])), (x.shape,)
    if l.kind == "pool2d":
        y = _pool2d_fwd(x, a["ksize"], a.get("stride", a["ksize"]))
        return y, (x,)   # backward needs the argmax source only (F+CD input)
    if l.kind == "add":
        y = xs[0]
        for other in xs[1:]:
            y = y + other
        return y, (len(xs),)
    if l.kind == "concat":
        axis = a.get("axis", -1)
        return torch.cat(xs, dim=axis), ([x.shape[axis] for x in xs], axis)
    if l.kind == "multiout":
        return x, ()
    if l.kind == "embedding":
        idx = x.to(torch.int64)
        flat = idx[..., 0] if idx.ndim > 1 else idx
        return p["w"][flat], (flat,)
    if l.kind == "lstm":
        h = x.new_zeros(x.shape[:-1] + (a["hidden"],)) if state is None \
            else state["h"]
        c = torch.zeros_like(h) if state is None else state["c"]
        h_new, c_new = _lstm_cell(x, h, c, p["wx"], p["wh"], p["b"])
        return h_new, (x, h, c)   # backward recomputes gates; outputs unused
    raise ValueError(f"forward not implemented for {l.kind}")


def layer_calc_gradient(l: LayerNode, ctx: Any, dy: Tensor,
                        p: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """CG phase: weight gradients from saved context + incoming derivative."""
    if l.kind == "linear":
        (x,) = ctx
        g = {"w": x.reshape(-1, x.shape[-1]).T @ dy.reshape(-1, dy.shape[-1])}
        if "b" in p:
            g["b"] = dy.reshape(-1, dy.shape[-1]).sum(0)
        return g
    if l.kind == "conv2d":
        (x,) = ctx
        a = l.attrs
        stride = a.get("stride", 1)
        xp = _conv_pad(x, p["w"].shape[-1], stride, a.get("padding", "same"))
        g = {"w": torch.nn.grad.conv2d_weight(xp, p["w"].shape, dy,
                                              stride=stride)}
        if "b" in p:
            g["b"] = dy.sum(dim=(0, 2, 3))
        return g
    if l.kind == "batchnorm":
        y, inv_std = ctx
        _, dgamma, dbeta = inplace.bn_deriv_from_output(
            y, p["gamma"], p["beta"], inv_std, dy)
        return {"gamma": dgamma, "beta": dbeta}
    if l.kind == "embedding":
        (idx,) = ctx
        flat_idx = idx.reshape(-1)
        g = torch.zeros(p["w"].shape, dtype=dy.dtype, device=dy.device)
        # accumulate into repeated rows in a fixed order (CUDA's index_add_
        # adds them with atomics, so two runs of one step could differ)
        return {"w": g.index_put_((flat_idx,),
                                  dy.reshape(flat_idx.shape[0], -1),
                                  accumulate=True)}
    if l.kind == "lstm":
        x, h0, c0 = ctx
        gwx, gwh, gb = _vjp(
            lambda wx, wh, b: _lstm_cell(x, h0, c0, wx, wh, b)[0],
            (p["wx"], p["wh"], p["b"]), dy)
        return {"wx": gwx, "wh": gwh, "b": gb}
    return {}


def layer_calc_derivative(l: LayerNode, ctx: Any, dy: Tensor,
                          p: Optional[Dict[str, Tensor]]) -> List[Tensor]:
    """CD phase: derivative(s) w.r.t. the layer's input(s)."""
    a = l.attrs
    if l.kind == "linear":
        return [dy @ p["w"].T]
    if l.kind == "conv2d":
        (x,) = ctx
        stride = a.get("stride", 1)
        hl, hh, wl, wh = _conv_pads(x, p["w"].shape[-1], stride,
                                    a.get("padding", "same"))
        padded = (x.shape[0], x.shape[1], x.shape[2] + hl + hh,
                  x.shape[3] + wl + wh)
        dxp = torch.nn.grad.conv2d_input(padded, p["w"], dy, stride=stride)
        # drop the rows and columns that padding added
        return [dxp[:, :, hl:hl + x.shape[2], wl:wl + x.shape[3]]]
    if l.kind == "activation":
        (y,) = ctx
        return [inplace.deriv_from_output(a["fn"], y, dy)]
    if l.kind == "batchnorm":
        y, inv_std = ctx
        dx, _, _ = inplace.bn_deriv_from_output(
            y, p["gamma"], p["beta"], inv_std, dy)
        return [dx]
    if l.kind in ("flatten", "reshape"):
        (shape,) = ctx
        return [dy.reshape(shape)]
    if l.kind == "pool2d":
        (x,) = ctx
        k, s = a["ksize"], a.get("stride", a["ksize"])
        return list(_vjp(lambda xx: _pool2d_fwd(xx, k, s), (x,), dy))
    if l.kind == "add":
        (n,) = ctx
        return [dy] * n
    if l.kind == "concat":
        sizes, axis = ctx
        return list(torch.split(dy, sizes, dim=axis))
    if l.kind == "multiout":
        return [dy]
    if l.kind == "embedding":
        return []  # integer inputs: no derivative
    if l.kind == "lstm":
        x, h0, c0 = ctx
        return list(_vjp(
            lambda xx: _lstm_cell(xx, h0, c0, p["wx"], p["wh"], p["b"])[0],
            (x,), dy))
    raise ValueError(f"calc_derivative not implemented for {l.kind}")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _sample_mask(mask: Tensor, pred: Tensor) -> Tuple[Tensor, Tensor]:
    """Broadcastable per-sample mask and its real-sample count.

    ``mask`` is (B,) with 1.0 for real samples and 0.0 for pad rows (the
    serve path pads ragged batches up to their bucket).  Masked rows get an
    exactly-zero loss derivative, so every downstream gradient matches the
    unpadded batch up to float association — provided no layer mixes
    samples across the batch dimension (true for every zoo graph;
    batchnorm would violate it).
    """
    m = torch.as_tensor(mask, dtype=pred.dtype, device=pred.device)
    return (m.reshape((-1,) + (1,) * (pred.ndim - 1)),
            torch.clamp(m.sum(), min=1.0))


def loss_forward(kind: str, pred: Tensor, label: Tensor,
                 mask: Optional[Tensor] = None) -> Tensor:
    if mask is None:
        if kind == "loss_mse":
            return torch.mean((pred - label) ** 2)
        if kind == "loss_ce":
            logp = torch.log_softmax(pred, dim=-1)
            return -torch.mean(torch.sum(label * logp, dim=-1))
        raise ValueError(kind)
    m, n_real = _sample_mask(mask, pred)
    if kind == "loss_mse":
        per_sample = pred.numel() // pred.shape[0]
        return torch.sum(m * (pred - label) ** 2) / (n_real * per_sample)
    if kind == "loss_ce":
        logp = torch.log_softmax(pred, dim=-1)
        per_sample_ce = torch.sum(label * logp, dim=-1, keepdim=True)
        return -torch.sum(m * per_sample_ce) / n_real
    raise ValueError(kind)


def loss_derivative(kind: str, pred: Tensor, label: Tensor,
                    mask: Optional[Tensor] = None) -> Tensor:
    if mask is None:
        n = pred.numel() if kind == "loss_mse" else pred.shape[0]
        if kind == "loss_mse":
            return 2.0 * (pred - label) / n
        if kind == "loss_ce":
            # combined softmax+CE derivative (the Loss realizer removed
            # softmax)
            return (torch.softmax(pred, dim=-1) - label) / n
        raise ValueError(kind)
    m, n_real = _sample_mask(mask, pred)
    if kind == "loss_mse":
        per_sample = pred.numel() // pred.shape[0]
        return 2.0 * m * (pred - label) / (n_real * per_sample)
    if kind == "loss_ce":
        return m * (torch.softmax(pred, dim=-1) - label) / n_real
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# The plain planned training step (no swap schedule)
# ---------------------------------------------------------------------------

@torch.no_grad()
def planned_loss_and_grads(graph: LayerGraph, params: Params,
                           x: Tensor, label: Tensor,
                           mask: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Params]:
    """One layer-basis training iteration: F sweep, then CG/CD sweep.

    Returns (loss, grads) with grads keyed by parameter-owner layer name;
    E-shared (unrolled) layers accumulate into their owner's entry.
    """
    acts: Dict[str, Tensor] = {"__input__": x}
    ctxs: Dict[str, Any] = {}
    loss_node = None
    loss_val = None

    # ---- Forward (EO 0..N-1) ------------------------------------------------
    for l in graph.layers:
        if l.kind in ("loss_mse", "loss_ce"):
            loss_node = l
            loss_val = loss_forward(l.kind, acts[l.inputs[0]], label, mask)
            continue
        xs = [acts[i] for i in l.inputs]
        p = params.get(_param_owner(graph, l))
        y, ctx = layer_forward(l, xs, p)
        acts[l.name] = y
        ctxs[l.name] = ctx

    # ---- Backward (EO N..3N): CG then CD per layer, reverse order ----------
    derivs: Dict[str, Tensor] = {}
    pred_name = loss_node.inputs[0]
    derivs[pred_name] = loss_derivative(loss_node.kind, acts[pred_name],
                                        label, mask)

    grads: Params = {}
    for l in reversed(graph.layers):
        if l.kind in ("loss_mse", "loss_ce"):
            continue
        dy = derivs.pop(l.name, None)   # Backward lifespan: consumed here
        if dy is None:
            continue  # dead derivative (pruned subgraph)
        p = params.get(_param_owner(graph, l))
        # CG phase
        if l.trainable and l.weight_shapes():
            g = layer_calc_gradient(l, ctxs[l.name], dy, p)
            owner = _param_owner(graph, l)
            if owner in grads:
                grads[owner] = {k: grads[owner][k] + g[k] for k in g}
            else:
                grads[owner] = g
        # CD phase — skipped when no upstream layer needs the derivative
        # (first layer / frozen backbone: dead-derivative pruning).
        upstream_needed = [
            i for i in l.inputs if i != "__input__" and _needs_deriv(graph, i)
        ]
        if upstream_needed:
            dxs = layer_calc_derivative(l, ctxs[l.name], dy, p)
            for inp, dx in zip(l.inputs, dxs):
                if inp == "__input__" or inp not in upstream_needed:
                    continue
                if inp in derivs:
                    derivs[inp] = derivs[inp] + dx   # fan-out accumulation
                else:
                    derivs[inp] = dx
    return loss_val, grads


def _needs_deriv(graph: LayerGraph, name: str) -> bool:
    node = graph.layer(name)
    if node.kind in WEIGHTED_KINDS and node.trainable and node.weight_shapes():
        return True
    return _has_trainable_upstream(graph, node)


# ---------------------------------------------------------------------------
# Whole-graph reference (conventional tape autodiff) for validation
# ---------------------------------------------------------------------------

def reference_forward(graph: LayerGraph, params: Params, x: Tensor) -> Tensor:
    acts: Dict[str, Tensor] = {"__input__": x}
    out = None
    for l in graph.layers:
        if l.kind in ("loss_mse", "loss_ce"):
            out = acts[l.inputs[0]]
            continue
        xs = [acts[i] for i in l.inputs]
        p = params.get(_param_owner(graph, l))
        y, _ = layer_forward(l, xs, p)
        acts[l.name] = y
    return out if out is not None else acts[graph.layers[-1].name]


def reference_loss_and_grads(graph: LayerGraph, params: Params,
                             x: Tensor, label: Tensor,
                             mask: Optional[Tensor] = None
                             ) -> Tuple[Tensor, Params]:
    """Loss and grads of the whole graph through ``torch.autograd``."""
    loss_kind = next(l.kind for l in graph.layers if l.kind.startswith("loss"))
    trainable_owners = {
        _param_owner(graph, l) for l in graph.layers
        if l.trainable and l.weight_shapes()
    }
    train_p = {k: {n: w.detach().requires_grad_(True) for n, w in v.items()}
               for k, v in params.items() if k in trainable_owners}
    frozen_p = {k: v for k, v in params.items() if k not in trainable_owners}
    with torch.enable_grad():
        pred = reference_forward(graph, {**frozen_p, **train_p}, x)
        loss = loss_forward(loss_kind, pred, label, mask)
        names = [(k, n) for k, v in train_p.items() for n in v]
        gs = torch.autograd.grad(loss, [train_p[k][n] for k, n in names],
                                 allow_unused=True)
    grads: Params = {k: {} for k in train_p}
    for (k, n), g in zip(names, gs):
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives
        grads[k][n] = torch.zeros_like(train_p[k][n]) if g is None \
            else g
    return loss.detach(), grads


def sgd_update(params: Params, grads: Params, lr: float = 1e-2) -> Params:
    out = {}
    for lname, entry in params.items():
        if lname in grads:
            out[lname] = {k: v - lr * grads[lname][k] for k, v in entry.items()}
        else:
            out[lname] = entry
    return out


@torch.no_grad()
def sgd_update_(params: Params, grads: Params, lr: float = 1e-2) -> Params:
    """:func:`sgd_update` in place: each parameter keeps its storage, so a
    replay whose CUDA graphs read the parameters where they were captured
    replays instead of capturing again.  Returns ``params``."""
    for lname, entry in params.items():
        if lname in grads:
            for k, v in entry.items():
                v.add_(grads[lname][k], alpha=-lr)
    return params
