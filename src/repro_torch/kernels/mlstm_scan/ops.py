"""The chunked mLSTM scan: intra-chunk kernel + stabilised cross-chunk
recurrence and combine.

Port of ``repro/kernels/mlstm_scan/ops.py:mlstm_scan``.  The forget gate
goes to log space (log-sigmoid), a ragged sequence is padded to whole
chunks (zeros, and -1e30 for the log input gate, which makes the padded
rows weightless), the chunks go to
:func:`repro_torch.kernels.mlstm_scan.kernel.mlstm_chunk` (the sm_90a
kernel for CUDA tensors, its plain twin for CPU tensors), and the
recurrence over the S/Q chunk states stays plain PyTorch, a loop as the
reference's ``lax.scan``: it is S/Q multiply-adds of (p, p) states.  The
inter-chunk product ``y_inter`` is a batched (Q, p) x (p, p) matmul that
the reference also leaves outside its kernel.

When autograd needs a gradient the scan runs as :class:`_MLSTMScan`: the
same forward, and a backward that recomputes ``repro_torch.models.xlstm.
mlstm_chunked`` (the port of the jnp function the reference
differentiates) from the saved q, k, v and gate logits and returns its
vjp.  The reference has no Pallas backward either.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_scan.kernel import mlstm_chunk
from repro_torch.kernels.recompute import vjp
from repro_torch.models.layers import log_sigmoid

Chunked = Tuple[torch.Tensor, ...]


def chunk_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 i_gate: torch.Tensor, f_gate: torch.Tensor, chunk: int
                 ) -> Chunked:
    """(b,s,...) inputs -> the kernel's contiguous float32 (b, nc, Q, ...)
    chunks q, k, v, li = i_gate and lf = log_sigmoid(f_gate), Q = min(chunk,
    s).  The last chunk is padded with zeros, and li with -1e30."""
    b, s, h, p = q.shape
    lf = log_sigmoid(f_gate.float())
    li = i_gate.float()
    qq = min(chunk, s)
    nc = -(-s // qq)
    pad = nc * qq - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        lf = F.pad(lf, (0, 0, 0, pad))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
    return (*(t.reshape(b, nc, qq, h, p).float().contiguous()
              for t in (q, k, v)),
            li.reshape(b, nc, qq, h).contiguous(),
            lf.reshape(b, nc, qq, h).contiguous())


class _MLSTMScan(torch.autograd.Function):
    """Forward by the kernel (its twin on the CPU), backward by the vjp of
    ``mlstm_chunked`` recomputed from the saved q, k, v and gate logits."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, chunk):
        ctx.save_for_backward(q, k, v, i_gate, f_gate)
        ctx.chunk = chunk
        return _forward(q, k, v, i_gate, f_gate, chunk)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.models.xlstm import mlstm_chunked
        return (*vjp(functools.partial(mlstm_chunked, chunk=ctx.chunk),
                     ctx.saved_tensors, ctx.needs_input_grad, dy), None)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_gate: torch.Tensor, f_gate: torch.Tensor, *,
               chunk: int = 256) -> torch.Tensor:
    """q,k,v: (b,s,h,p); i_gate,f_gate: (b,s,h) raw logits -> (b,s,h,p),
    float32.  Under autograd it runs as :class:`_MLSTMScan`; outside it
    (serving) the kernel runs without the Function."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_gate, f_gate)):
        return _MLSTMScan.apply(q, k, v, i_gate, f_gate, chunk)
    return _forward(q, k, v, i_gate, f_gate, chunk)


def _forward(q, k, v, i_gate, f_gate, chunk):
    b, s, h, p = q.shape
    scale = 1.0 / math.sqrt(p)
    qc, kc, vc, lic, lfc = chunk_inputs(q, k, v, i_gate, f_gate, chunk)
    nc, qq = qc.shape[1:3]
    y_i, n_i, m_i, states, norms, chunk_lf, m_state = mlstm_chunk(
        qc, kc, vc, lic, lfc, scale)

    # ---- cross-chunk stabilised recurrence (emits the state before each
    # chunk) ---------------------------------------------------------------
    C_prev = torch.empty_like(states)                    # (b,nc,h,p,p)
    n_prev = torch.empty_like(norms)                     # (b,nc,h,p)
    m_prev = torch.empty_like(m_state)                   # (b,nc,h)
    C = torch.zeros_like(states[:, 0])
    n = torch.zeros_like(norms[:, 0])
    m = torch.full_like(m_state[:, 0], -1e30)
    for c in range(nc):
        C_prev[:, c], n_prev[:, c], m_prev[:, c] = C, n, m
        m_new = torch.maximum(m + chunk_lf[:, c], m_state[:, c])
        alpha = torch.exp(m + chunk_lf[:, c] - m_new)
        beta = torch.exp(m_state[:, c] - m_new)
        C = C * alpha[..., None, None] + states[:, c] * beta[..., None, None]
        n = n * alpha[..., None] + norms[:, c] * beta[..., None]
        m = m_new

    # ---- combine intra + inter --------------------------------------------
    lf_cum = torch.cumsum(lfc, dim=2)                    # (b,nc,Q,h)
    inter_decay = lf_cum + m_prev[:, :, None, :]
    m_total = torch.maximum(m_i, inter_decay)
    w_intra = torch.exp(m_i - m_total)
    w_inter = torch.exp(inter_decay - m_total)

    qs = qc * scale * w_inter[..., None]
    y_inter = torch.einsum("bcqhp,bchpr->bcqhr", qs, C_prev)
    n_inter = torch.einsum("bcqhp,bchp->bcqh", qs, n_prev)
    num = y_i * w_intra[..., None] + y_inter
    den = torch.maximum((n_i * w_intra + n_inter).abs(), torch.exp(-m_total))
    y = num / den[..., None]
    return y.reshape(b, nc * qq, h, p)[:, :s]
