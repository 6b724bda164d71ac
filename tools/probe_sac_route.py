#!/usr/bin/env python3
"""Can ``torch.utils.checkpoint``'s selective mode carry the memory plan's
keep / recompute / offload policy, instead of ``repro_torch.core.remat``?

    python3 tools/probe_sac_route.py

Runs on the CPU in a second.  The kernels become ``torch.library`` custom
ops (opaque to autograd, backward by recompute through a plain twin, as
the port's flash and SwiGLU wrappers do), and a name becomes visible to a
selective-checkpoint policy in one of two ways: a ``tag`` op after the
producer (the reference's ``checkpoint_name``; a custom op may not return
its input, so it copies), or the name passed to the kernel op itself.  A
toy block shaped like the port's dense block (q projection tagged
``qkv``, an attention op tagged ``attn_out``, a SwiGLU op tagged
``mlp_hidden``), 2 layers of 48 tokens at width 64, fp32, is
backpropagated under each policy and printed against what
``tests/test_torch_remat.py`` asks of the port: gradients bit for bit
those of remat off, the bytes held per block those of the kept tags, and
kernel launches only where the plan recomputes.  Offload is the fourth
requirement: the policy's choices are printed as the API defines them.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

LAYERS, S, D, F = 2, 48, 64, 128
NAMES = ("qkv", "attn_out", "mlp_hidden")
LAUNCHES = {"attn": 0, "swiglu": 0}


def _attn_plain(q, k, v):
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    causal = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    return torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v


def _swiglu_plain(x, wg, wu):
    return torch.nn.functional.silu(x @ wg) * (x @ wu)


@torch.library.custom_op("sac_probe::attn", mutates_args=())
def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         name: str) -> torch.Tensor:
    LAUNCHES["attn"] += 1
    with torch.no_grad():
        return _attn_plain(q, k, v)


@torch.library.custom_op("sac_probe::swiglu", mutates_args=())
def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           name: str) -> torch.Tensor:
    LAUNCHES["swiglu"] += 1
    with torch.no_grad():
        return _swiglu_plain(x, wg, wu)


@torch.library.custom_op("sac_probe::tag", mutates_args=())
def tag_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


def _by_twin(twin):
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3])

    def backward(ctx, grad):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = twin(*ins)
        return (*torch.autograd.grad(out, ins, grad), None)
    return backward, setup_context


for _op, _twin in ((attn, _attn_plain), (swiglu, _swiglu_plain)):
    _backward, _setup = _by_twin(_twin)
    _op.register_autograd(_backward, setup_context=_setup)
tag_op.register_autograd(lambda ctx, grad: (grad, None))


def block(p, x, names_on_kernels):
    h = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
    q = tag_op(h @ p["wq"], "qkv")
    a = attn(q, h @ p["wk"], h @ p["wv"],
             "attn_out" if names_on_kernels else "")
    if not names_on_kernels:
        a = tag_op(a, "attn_out")
    x = x + a @ p["wo"]
    h = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6)
    m = swiglu(h, p["wg"], p["wu"], "mlp_hidden" if names_on_kernels else "")
    if not names_on_kernels:
        m = tag_op(m, "mlp_hidden")
    return x + m @ p["wd"]


def _policy(keep, offload, ctx, op, *args, **kwargs):
    named = (torch.ops.sac_probe.tag.default, torch.ops.sac_probe.attn.default,
             torch.ops.sac_probe.swiglu.default)
    if op in named and args[-1] in keep:
        return CheckpointPolicy.MUST_SAVE
    if op in named and args[-1] in offload:
        return CheckpointPolicy.MUST_CPU_OFFLOAD
    return CheckpointPolicy.PREFER_RECOMPUTE


def run(keep, remat, names_on_kernels, offload=()):
    """(loss, grads, forward launches, all launches, bytes each block's
    selective-checkpoint cache held)."""
    g = torch.Generator().manual_seed(0)
    shapes = dict(wq=(D, D), wk=(D, D), wv=(D, D), wo=(D, D), wg=(D, F),
                  wu=(D, F), wd=(F, D))
    params = [{k: (torch.randn(shape, generator=g) / shape[0] ** 0.5)
               .requires_grad_() for k, shape in shapes.items()}
              for _ in range(LAYERS)]
    x = torch.randn(S, D, generator=g)
    caches = []

    def contexts():
        fwd, replay = create_selective_checkpoint_contexts(
            functools.partial(_policy, keep, offload))
        caches.append(fwd.storage)
        return fwd, replay

    for k in LAUNCHES:
        LAUNCHES[k] = 0
    y = x
    for p in params:
        y = checkpoint(block, p, y, names_on_kernels, use_reentrant=False,
                       context_fn=contexts) if remat \
            else block(p, y, names_on_kernels)
    forward = dict(LAUNCHES)
    held = [sum(w.val.numel() * w.val.element_size()
                for per_op in cache.values()
                for w in (per_op.values() if isinstance(per_op, dict)
                          else per_op)     # a list before torch 2.13
                if isinstance(getattr(w, "val", None), torch.Tensor))
            for cache in caches]
    loss = (y ** 2).mean()
    loss.backward()
    grads = [torch.cat([t.grad.flatten() for t in p.values()])
             for p in params]
    return loss.detach(), grads, forward, dict(LAUNCHES), held


def main() -> None:
    want_loss, want, _, _, _ = run((), False, False)
    tagged = S * D * 4 * 2 + S * F * 4     # qkv, attn_out, mlp_hidden
    rows = []
    for names_on_kernels in (False, True):
        for keep in ((), NAMES):
            loss, grads, fwd, total, held = run(keep, True, names_on_kernels)
            rows.append({
                "names_on": "kernel ops" if names_on_kernels else "tag ops",
                "keep": list(keep),
                "bitwise_equal_to_remat_off": bool(
                    torch.equal(loss, want_loss)
                    and all(torch.equal(a, b) for a, b in zip(grads, want))),
                "held_bytes_per_block": held[0],
                "kept_tagged_bytes_per_block": tagged if keep else 0,
                "launches_forward": fwd,
                "launches_in_replays": {k: total[k] - fwd[k] for k in total},
            })
    if hasattr(CheckpointPolicy, "MUST_CPU_OFFLOAD"):
        # keep two tags, offload mlp_hidden: does its output reach the host
        # and stay out of the replay?
        loss, grads, fwd, total, held = run(NAMES[:2], True, True,
                                            offload=NAMES[2:])
        rows.append({
            "names_on": "kernel ops", "keep": list(NAMES[:2]),
            "offload": list(NAMES[2:]),
            "bitwise_equal_to_remat_off": bool(
                torch.equal(loss, want_loss)
                and all(torch.equal(a, b) for a, b in zip(grads, want))),
            "held_bytes_per_block": held[0],
            "kept_tagged_bytes_per_block": S * D * 4 * 2,
            "launches_forward": fwd,
            "launches_in_replays": {k: total[k] - fwd[k] for k in total},
        })
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"torch": torch.__version__,
                      "policy_choices": [c.name for c in CheckpointPolicy]}))


if __name__ == "__main__":
    main()
