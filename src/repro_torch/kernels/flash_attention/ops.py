"""Public (B, S, H, D) wrapper for the flash-attention kernel, with its
backward.

Port of ``repro/kernels/flash_attention/ops.py:flash_attention``.  The
forward is the kernel (:func:`flash_attention_fwd`: the sm_90a kernel for
CUDA tensors, its plain twin for CPU tensors); the (B, S, H, D) tensors
are passed to it as (B, H, S, D) views, which it reads through their
strides, so no transpose is copied (the kernels write (B, S, H, D)
when q is laid out so; the plain twin's (B, H, S, D) output is made
contiguous).  The backward is the reference's
``_flash_bwd``: it recomputes the attention through the memory-efficient
blockwise formulation (``repro_torch.models.attention.blockwise_attention``)
under autograd, with K and V repeated over the GQA groups and dk, dv summed
back, and never stores an S x S residual.  It does so one query block at a
time, each against the keys up to its causal edge: the query blocks of the
blockwise schedule are independent, so this is the same function, and
only one block's scores are live (all of them, for 24 heads at 4096
tokens, would be 1.6 GB of fp32).
"""

from __future__ import annotations

import torch

from repro_torch.core.remat import produce
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    """Forward by the kernel, backward by blockwise recompute; saves only
    q, k, v (so a checkpoint replay that kept the output skips the
    kernel: :func:`repro_torch.core.remat.produce`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (causal, block_q, block_kv)
        return produce(lambda: _forward(q, k, v, causal, block_q,
                                        block_kv))

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do, *ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, causal: bool, block_q: int,
                        block_kv: int):
    """(dq, dk, dv) of the (B, S, H, D) flash attention at ``do``: the
    vjp of ``blockwise_attention`` on K, V repeated over the groups, one
    query block at a time."""
    from repro_torch.models.attention import _repeat_kv, blockwise_attention
    sq, skv = q.shape[1], k.shape[1]
    groups = q.shape[2] // k.shape[2]
    block = min(block_q, sq)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, sq, block):
        q1 = min(q0 + block, sq)
        kv_end = min(q1, skv) if causal else skv
        with torch.enable_grad():
            qb = q[:, q0:q1].detach().requires_grad_()
            kb = k[:, :kv_end].detach().requires_grad_()
            vb = v[:, :kv_end].detach().requires_grad_()
            o = blockwise_attention(qb, _repeat_kv(kb, groups),
                                    _repeat_kv(vb, groups), causal=causal,
                                    block_q=block, block_kv=block_kv,
                                    q_offset=q0)
            dqb, dkb, dvb = torch.autograd.grad(o, (qb, kb, vb),
                                                do[:, q0:q1])
        dq[:, q0:q1] = dqb
        dk[:, :kv_end] += dkb
        dv[:, :kv_end] += dvb
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 1024) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D).
    Outside autograd (serving) the kernel runs without the Function."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, block_q, block_kv)
    return _forward(q, k, v, causal, block_q, block_kv)


def _forward(q, k, v, causal, block_q, block_kv):
    return flash_attention_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, block_q=block_q,
        block_kv=block_kv).transpose(1, 2).contiguous()
