"""Plain PyTorch oracle for flash attention (exact softmax attention).

Port of ``repro/kernels/flash_attention/ref.py``.  The causal mask aligns
bottom-right (``tril(..., skv - sq)``), as the reference oracle does; the
kernel and the models align top-left, so the two agree on causal
attention only when Sq == Skv.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    Materialises the full score matrix: correct but O(Sq*Skv) memory.
    """
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    groups = hq // hkv
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
