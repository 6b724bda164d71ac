"""Public (B, S, H, D) wrapper for the flash-attention kernel.

Port of ``repro/kernels/flash_attention/ops.py:flash_attention``.  Forward
only: the reference's recompute backward (``ops.py:_flash_bwd``) comes with
the training slice, so a call that would need a gradient raises.  The
(B, S, H, D) tensors are passed to the kernel as (B, H, S, D) views; the
kernel reads through their strides, so no transpose is copied.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 1024) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the port; its backward "
            "comes with the training slice")
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              block_q=block_q, block_kv=block_kv)
    return out.transpose(1, 2)
