"""AdamW and momentum SGD over parameter trees, in PyTorch.

Port of ``repro/optim/optimizers.py`` with the same defaults.  Each
optimizer has one body, ``update_(grads, state, params)``, which writes
the new parameters and state into ``params`` and ``state`` leaf by leaf,
so old and new state never coexist (the train step's update); the
reference's functional interface, ``update(grads, state, params) ->
(new_params, new_state)``, runs that body on copies.  AdamW's body is
also given in parts (``Optimizer.adamw``, :class:`AdamWParts`): count the
step, update a leaf's moments, update the parameter from them, store the
moments (all of them or a run of their blocks), and the state's layout
(each moment's leaf shapes; a fresh state allocated at given shapes); a
sharded step whose moments and parameter blocks do not line up (the int8
moments' flat blocks on a mesh, ``train/step.py``) calls them itself.
AdamW keeps its
moments in fp32, bf16, or int8 blocks with fp32 scales
(``compression._q``: absmax / 127 per 256 elements, the reference's
``_quantize``); the bias corrections are computed in fp32 from an int32
step count, as the reference computes them.  This is the resident
baseline the offloaded optimizer (``repro_torch.core.optim_offload``) is
held to.  Trees are nested dicts, lists and tuples of tensors; the state
trees mirror the parameter tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.compression import _deq, _q, tree_map

QBLOCK = 256  # quantisation block (elements) for int8 moment storage


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    # update_(grads, state, params): the step, written into ``params`` and
    # ``state`` leaf by leaf
    update_: Callable[..., None]
    name: str = "opt"
    # AdamW's parts of ``update_`` (None for another optimizer)
    adamw: Optional["AdamWParts"] = None

    def update(self, grads, state, params, *_) -> Tuple[Any, Any]:
        """The step on copies: (new_params, new_state), the arguments
        untouched."""
        params, state = _clone(params), _clone(state)
        self.update_(grads, state, params)
        return params, state


class AdamWParts(NamedTuple):
    """One AdamW step in parts, the arithmetic of ``update_``'s:
    ``begin(state)`` counts the step and returns its bias corrections;
    ``moments(g, mv, shape)`` the fp32 moments (m, v) after this step's
    update of ``mv`` (``mv``'s own tensors for fp32 moments, which it
    updates; new ones otherwise, ``mv`` untouched); ``param(p, m, v,
    corrections)`` updates ``p`` in place; ``store(mv, m, v, rows=None)``
    writes the moments back in ``mv``'s format (with ``rows`` = (r0, r1)
    for int8 moments: only the blocks r0..r1 of the flat moments, which
    ``mv`` holds).  The layout: ``moment_shape(shape)`` is a moment's leaf
    shapes for a parameter of ``shape`` (its own, or
    :func:`int8_block_shapes`); ``init_at(shapes, device)`` a fresh state
    whose moments have the leaf shapes of ``shapes`` (by parameter name
    ``{"m": ..., "v": ...}``, each ``moment_shape``'s tree or a block of
    it); ``flat`` is whether the moments are blocks of the flat parameter
    rather than of its shape (int8)."""
    begin: Callable[[Any], Any]
    moments: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    param: Callable[..., None]
    store: Callable[..., None]
    moment_shape: Callable[[Tuple[int, ...]], Any]
    init_at: Callable[..., Any]
    flat: bool


def int8_block_shapes(shape) -> Dict[str, Tuple[int, int]]:
    """An int8 moment's leaf shapes for a tensor of ``shape``: ``q`` (nb,
    QBLOCK) and ``scale`` (nb, 1), nb blocks of its flat elements (the
    last padded with zeros)."""
    nb = -(-math.prod(shape) // QBLOCK)
    return {"q": (nb, QBLOCK), "scale": (nb, 1)}


def _flat_rows(t: torch.Tensor, rows: Tuple[int, int]) -> torch.Tensor:
    """The elements of ``t``'s quantisation blocks r0..r1, flat, zero past
    its last element."""
    r0, r1 = rows
    flat = t.reshape(-1)[r0 * QBLOCK:min(r1 * QBLOCK, t.numel())]
    return torch.nn.functional.pad(flat, (0, (r1 - r0) * QBLOCK
                                          - flat.numel()))


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _quantize(x: torch.Tensor):
    q, scale = _q(x)
    return {"q": q, "scale": scale}


def _dequantize(qs, shape) -> torch.Tensor:
    return _deq(qs["q"], qs["scale"], shape)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          state_dtype: str = "float32") -> Optimizer:
    """state_dtype: 'float32' | 'bfloat16' | 'int8' (block-quantised)."""
    if state_dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unknown state_dtype {state_dtype!r}")

    def init(params):
        def one(p):
            if state_dtype == "int8":
                z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                return {"m": _quantize(z), "v": _quantize(z)}
            dt = torch.bfloat16 if state_dtype == "bfloat16" \
                else torch.float32
            return {"m": torch.zeros(p.shape, dtype=dt, device=p.device),
                    "v": torch.zeros(p.shape, dtype=dt, device=p.device)}
        first = next(_leaves(params), None)
        dev = first.device if first is not None else None
        return {"mu": tree_map(one, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def begin_(state):
        """Count the step; its bias corrections (c1, c2)."""
        state["count"].add_(1)
        t = state["count"].to(torch.float32)
        return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)

    @torch.no_grad()
    def moments(g, mv, shape):
        gf = g.to(torch.float32)
        if state_dtype == "int8":
            m = _dequantize(mv["m"], shape)
            v = _dequantize(mv["v"], shape)
        elif state_dtype == "bfloat16":
            m = mv["m"].to(torch.float32)
            v = mv["v"].to(torch.float32)
        else:
            m, v = mv["m"], mv["v"]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf * gf)
        return m, v

    @torch.no_grad()
    def param(p, m, v, corrections):
        c1, c2 = corrections
        upd = (m / c1) / (torch.sqrt(v / c2) + eps)
        p.copy_(p - lr * (upd + weight_decay * p.to(torch.float32)))

    @torch.no_grad()
    def store(mv, m, v, rows=None):
        if state_dtype == "int8":
            for name, moment in (("m", m), ("v", v)):
                q = _quantize(moment if rows is None
                              else _flat_rows(moment, rows))
                mv[name]["q"].copy_(q["q"])
                mv[name]["scale"].copy_(q["scale"])
        elif state_dtype == "bfloat16":
            mv["m"].copy_(m)
            mv["v"].copy_(v)

    def leaf_(g, mv, p, corrections):
        """One leaf's step in place: ``p`` and its moments ``mv``."""
        m, v = moments(g, mv, p.shape)
        param(p, m, v, corrections)
        store(mv, m, v)

    def update_(grads, state, params, *_):
        """One AdamW step in place; one leaf's temporaries live at a
        time."""
        c = begin_(state)
        tree_map(lambda g, mv, p: leaf_(g, mv, p, c), grads, state["mu"],
                 params)

    def moment_shape(shape):
        return int8_block_shapes(shape) if state_dtype == "int8" \
            else tuple(shape)

    def init_at(shapes, device):
        def moment(s):
            if state_dtype == "int8":
                # the quantised zero moment (``_quantize`` of zeros)
                return {"q": torch.zeros(s["q"], dtype=torch.int8,
                                         device=device),
                        "scale": torch.ones(s["scale"], dtype=torch.float32,
                                            device=device)}
            dt = torch.bfloat16 if state_dtype == "bfloat16" \
                else torch.float32
            return torch.zeros(s, dtype=dt, device=device)
        return {"mu": {n: {k: moment(mv[k]) for k in ("m", "v")}
                       for n, mv in shapes.items()},
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    return Optimizer(init=init, update_=update_, name=f"adamw_{state_dtype}",
                     adamw=AdamWParts(begin_, moments, param, store,
                                      moment_shape, init_at,
                                      flat=state_dtype == "int8"))


def sgd_momentum(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mom": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)}

    @torch.no_grad()
    def update_(grads, state, params, *_):
        def one(g, m, p):
            m.mul_(momentum).add_(g.to(torch.float32))
            p.copy_(p - lr * m)
        tree_map(one, grads, state["mom"], params)

    return Optimizer(init=init, update_=update_, name="sgd_momentum")


def make_optimizer(name: str, **kw) -> Optimizer:
    if name.startswith("adamw"):
        return adamw(**kw)
    if name == "sgd":
        return sgd_momentum(**kw)
    raise ValueError(name)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
