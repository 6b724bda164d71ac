"""Oracle for the mLSTM scan: the exact stabilised sequential recurrence
(xLSTM arXiv:2405.04517, eqs. 19-27).

Port of ``repro/kernels/mlstm_scan/ref.py``::

    m_t = max(log f_t + m_{t-1}, i_t)
    C_t = exp(log f_t + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) v_t k_t^T
    n_t = exp(log f_t + m_{t-1} - m_t) n_{t-1} + exp(i_t - m_t) k_t
    y_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t))
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import log_sigmoid


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_gate: torch.Tensor, f_gate: torch.Tensor) -> torch.Tensor:
    """q,k,v: (b,s,h,p); i_gate,f_gate: (b,s,h) raw logits -> (b,s,h,p),
    float32."""
    b, s, h, p = q.shape
    scale = 1.0 / math.sqrt(p)
    q, k, v, li = (t.float() for t in (q, k, v, i_gate))
    lf = log_sigmoid(f_gate).float()
    C = torch.zeros(b, h, p, p, device=q.device)
    n = torch.zeros(b, h, p, device=q.device)
    m = torch.full((b, h), -1e30, device=q.device)
    ys = []
    for t in range(s):
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        alpha = torch.exp(lf[:, t] + m - m_new)
        beta = torch.exp(li[:, t] - m_new)
        C = C * alpha[..., None, None] + beta[..., None, None] \
            * torch.einsum("bhp,bhr->bhpr", k[:, t], v[:, t])
        n = n * alpha[..., None] + beta[..., None] * k[:, t]
        m = m_new
        qs = q[:, t] * scale
        num = torch.einsum("bhp,bhpr->bhr", qs, C)
        den = torch.maximum(torch.einsum("bhp,bhp->bh", qs, n).abs(),
                            torch.exp(-m))
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1)
