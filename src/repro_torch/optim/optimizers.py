"""AdamW and momentum SGD over parameter trees, in PyTorch.

Port of ``repro/optim/optimizers.py`` with the same defaults.  Each
optimizer has one body, ``update_(grads, state, params)``, which writes
the new parameters and state into ``params`` and ``state`` leaf by leaf,
so old and new state never coexist (the train step's update); the
reference's functional interface, ``update(grads, state, params) ->
(new_params, new_state)``, runs that body on copies.  AdamW keeps its
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
from typing import Any, Callable, Tuple

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

    def update(self, grads, state, params, *_) -> Tuple[Any, Any]:
        """The step on copies: (new_params, new_state), the arguments
        untouched."""
        params, state = _clone(params), _clone(state)
        self.update_(grads, state, params)
        return params, state


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
    def update_(grads, state, params, *_):
        """One AdamW step in place; one leaf's temporaries live at a
        time."""
        state["count"].add_(1)
        t = state["count"].to(torch.float32)
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def one(g, mv, p):
            gf = g.to(torch.float32)
            if state_dtype == "int8":
                m = _dequantize(mv["m"], p.shape)
                v = _dequantize(mv["v"], p.shape)
            elif state_dtype == "bfloat16":
                m = mv["m"].to(torch.float32)
                v = mv["v"].to(torch.float32)
            else:
                m, v = mv["m"], mv["v"]
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf * gf)
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            p.copy_(p - lr * (upd + weight_decay * p.to(torch.float32)))
            if state_dtype == "int8":
                for name, moment in (("m", m), ("v", v)):
                    q = _quantize(moment)
                    mv[name]["q"].copy_(q["q"])
                    mv[name]["scale"].copy_(q["scale"])
            elif state_dtype == "bfloat16":
                mv["m"].copy_(m)
                mv["v"].copy_(v)

        tree_map(one, grads, state["mu"], params)

    return Optimizer(init=init, update_=update_, name=f"adamw_{state_dtype}")


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
