"""The model-facing fused SwiGLU wrapper.

Port of ``repro/kernels/fused_swiglu/ops.py:fused_swiglu``.  It folds the
leading dims of a dense MLP's input, (..., K) -> (M, K), calls
:func:`repro_torch.kernels.fused_swiglu.kernel.fused_swiglu` (the sm_90a
kernel for CUDA tensors, its plain twin for CPU tensors) and unfolds the
result; the expert form, x (E, M, K) with wg, wu (E, K, F), goes through
as one launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_swiglu import kernel


def fused_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
                 ) -> torch.Tensor:
    """x: (..., K), wg, wu: (K, F) -> (..., F); or x: (E, M, K), wg, wu:
    (E, K, F) -> (E, M, F).  h = silu(x wg) * (x wu), rounded once to
    x's dtype."""
    wg, wu = wg.contiguous(), wu.contiguous()
    if wg.dim() == 3:
        return kernel.fused_swiglu(x.contiguous(), wg, wu)
    h = kernel.fused_swiglu(x.reshape(-1, x.shape[-1]).contiguous(), wg, wu)
    return h.reshape(*x.shape[:-1], h.shape[-1])
