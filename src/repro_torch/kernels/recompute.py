"""The backward the SSD and mLSTM scans share: recompute a differentiable
PyTorch function of the saved inputs and return its vjp (the reference
differentiates its jnp functions; it has no Pallas backward)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


def vjp(fn: Callable[..., torch.Tensor], saved: Sequence[torch.Tensor],
        needs: Sequence[bool], dy: torch.Tensor
        ) -> List[Optional[torch.Tensor]]:
    """The grads of ``fn(*saved)`` at ``dy`` for the inputs that need one
    (``needs``, a Function's ``needs_input_grad``) and None for the
    others; ``fn`` runs in float32 on detached copies, and each grad comes
    back in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(need)
                  for t, need in zip(saved, needs)]
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, dy)
                     if wanted else ())
    return [next(grads).to(t.dtype) if need else None
            for t, need in zip(saved, needs)]
