"""The chunked SSD scan: intra-chunk kernel + inter-chunk recurrence, with
its backward.

Port of ``repro/kernels/ssm_scan/ops.py:ssd_scan``.  A ragged sequence is
padded with zeros to whole chunks (dt = 0 makes the padded rows neutral),
the chunks go to :func:`repro_torch.kernels.ssm_scan.kernel.ssd_chunk` (the
sm_90a kernel for CUDA tensors, its plain twin for CPU tensors), and the
recurrence over the S/Q chunk states stays plain PyTorch, a loop as the
reference's ``lax.scan``: it is S/Q small multiply-adds.

When autograd needs a gradient the scan runs as :class:`_SSDScan`: the same
forward, and a backward that recomputes ``repro_torch.models.ssm.
ssd_chunked`` (the port of the jnp function the reference differentiates)
from the saved inputs and returns its vjp.  The reference has no Pallas
backward either.  The kernel's plain twin is not differentiated: its L is
a select after the exp, whose backward multiplies a zero cotangent by the
inf above the diagonal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.recompute import vjp
from repro_torch.kernels.ssm_scan.kernel import log_decay, ssd_chunk

Chunked = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def chunk_inputs(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int) -> Chunked:
    """(b,s,...) inputs -> contiguous float32 (b, nc, Q, ...) chunks, the
    last one padded with zeros; Q = min(chunk, s)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return (x.reshape(b, nc, q, h, p).float().contiguous(),
            dt.reshape(b, nc, q, h).float().contiguous(),
            B.reshape(b, nc, q, n).float().contiguous(),
            C.reshape(b, nc, q, n).float().contiguous())


class _SSDScan(torch.autograd.Function):
    """Forward by the kernel (its twin on the CPU), backward by the vjp of
    ``ssd_chunked`` recomputed from the saved x, dt, A_log, B and C."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, chunk):
        ctx.save_for_backward(x, dt, A_log, B, C)
        ctx.chunk = chunk
        return _forward(x, dt, A_log, B, C, chunk)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.models.ssm import ssd_chunked
        return (*vjp(functools.partial(ssd_chunked, chunk=ctx.chunk),
                     ctx.saved_tensors, ctx.needs_input_grad, dy), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
             ) -> torch.Tensor:
    """x: (b,s,h,p); dt: (b,s,h); A_log: (h,); B,C: (b,s,n) -> (b,s,h,p),
    float32.  Under autograd it runs as :class:`_SSDScan`; outside it
    (serving) the kernel runs without the Function."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A_log, B, C)):
        return _SSDScan.apply(x, dt, A_log, B, C, chunk)
    return _forward(x, dt, A_log, B, C, chunk)


def _forward(x, dt, A_log, B, C, chunk):
    b, s, h, p = x.shape
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, chunk)
    A_log = A_log.float().contiguous()
    y_diag, states, chunk_lf = ssd_chunk(xc, dtc, A_log, Bc, Cc)

    # ---- inter-chunk recurrence (sequential over nc chunk states) --------
    chunk_decay = torch.exp(chunk_lf)                     # (b,nc,h)
    prev = torch.empty_like(states)                       # (b,nc,h,n,p)
    carry = torch.zeros_like(states[:, 0])
    for c in range(states.shape[1]):
        prev[:, c] = carry                                # emit previous
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]

    # ---- inter-chunk contribution y_off = C . exp(dA_cum) . prev --------
    state_decay = torch.exp(log_decay(dtc, A_log).float())   # (b,nc,Q,h)
    y_off = torch.einsum("bcqn,bchnp->bcqhp", Cc, prev) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, -1, h, p)
    return y[:, :s]
