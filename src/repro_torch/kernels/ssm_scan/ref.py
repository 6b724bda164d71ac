"""Oracle for the SSD/mamba2 scan: the exact sequential recurrence.

Port of ``repro/kernels/ssm_scan/ref.py``::

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T      (outer product)
    y_t = C_t . h_t

h: (N, P) per head; A = -exp(A_log) (negative decay rate).
"""

from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x: (b,s,h,p); dt: (b,s,h); A_log: (h,); B,C: (b,s,n) -> y: (b,s,h,p)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    A = -torch.exp(A_log)                                   # (h,)
    state = torch.zeros(b, h, n, p, dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A[None])                  # (b,h)
        dBx = torch.einsum("bn,bh,bhp->bhnp", B[:, t], dt[:, t], x[:, t])
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], state))
    return torch.stack(ys, dim=1)                           # (b,s,h,p)
