"""Oracle for the fused SwiGLU kernel.

Port of ``repro/kernels/fused_swiglu/ref.py``: both products in fp32,
``silu(g) * u`` in fp32, then one cast to x's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
               ) -> torch.Tensor:
    """x: (M, K); wg, wu: (K, F) -> silu(x wg) * (x wu), fp32 accumulation."""
    g = x.float() @ wg.float()
    u = x.float() @ wu.float()
    return (F.silu(g) * u).to(x.dtype)
