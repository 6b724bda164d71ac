"""mLSTM intra-chunk kernel on Hopper: build-and-launch wrapper + plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_scan/kernel.py:
mlstm_chunk_pallas``.  The CUDA C++ source is ``csrc/mlstm_chunk.cu``
(sm_90a); its header says what bounds it on the H100 and how its three
passes answer that.  It is compiled at first use and loaded with ``ctypes``
by ``repro_torch.kernels._build``.

:func:`mlstm_chunk` launches that kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
:func:`mlstm_chunk_plain`, the kernel's plain PyTorch twin, which computes
the TPU kernel's per (batch, chunk, head) math for every unit at once.
``LAUNCHES`` counts calls of the kernel's entry point (its three passes
are one launch here), so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

TILE = 64            # the kernel's tile; its W scratch is padded to it
MAX_CHUNK = 256      # one chunk row per thread in the kernel's scan
MAX_HEAD_DIM = 1024

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"

LAUNCHES = 0          # kernel launches; set to 0 before a counted run

_lib: Optional[ctypes.CDLL] = None

Outputs = Tuple[torch.Tensor, ...]


def build() -> ctypes.CDLL:
    """Compile ``csrc/mlstm_chunk.cu`` (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.mlstm_chunk_fwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mlstm_chunk_error_string.argtypes = [ctypes.c_int]
    lib.mlstm_chunk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(q, k, v, li, lf) -> None:
    if q.dim() != 5:
        raise ValueError("q must be (b, nc, Q, h, p)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match q {tuple(q.shape)}")
    if li.shape != q.shape[:4] or lf.shape != q.shape[:4]:
        raise ValueError(f"li {tuple(li.shape)} and lf {tuple(lf.shape)} "
                         f"must be {tuple(q.shape[:4])}")
    if len({t.device for t in (q, k, v, li, lf)}) != 1:
        raise ValueError("q, k, v, li, lf must lie on one device")


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                li: torch.Tensor, lf: torch.Tensor, sm_scale: float
                ) -> Outputs:
    """Intra-chunk mLSTM.

    q, k, v: (b, nc, Q, h, p); li, lf: (b, nc, Q, h) (log input gate, log
    forget gate) -> (y_intra (b, nc, Q, h, p), n_intra (b, nc, Q, h),
    m_intra (b, nc, Q, h), states (b, nc, h, p, p), norms (b, nc, h, p),
    chunk_lf (b, nc, h), m_state (b, nc, h)), all float32.

    CUDA tensors go to the sm_90a kernel, CPU tensors to the plain twin.
    """
    _check(q, k, v, li, lf)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, li, lf, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, li, lf, sm_scale)


def _launch(q, k, v, li, lf, sm_scale) -> Outputs:
    global LAUNCHES
    b, nc, nq, h, p = q.shape
    ins = (q, k, v, li, lf)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError("the kernel takes float32 inputs")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("the kernel takes contiguous inputs")
    if p % 16 or not 16 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims that are multiples of "
                         f"16 up to {MAX_HEAD_DIM}, not {p}")
    if not 1 <= nq <= MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of 1..{MAX_CHUNK} rows, "
                         f"not {nq}")
    units = b * nc * h
    if units >= 2 ** 31:
        raise ValueError("grid too large")
    f32 = dict(dtype=torch.float32, device=q.device)
    y = torch.empty_like(q)
    n_intra = torch.empty(b, nc, nq, h, **f32)
    m_intra = torch.empty(b, nc, nq, h, **f32)
    states = torch.empty(b, nc, h, p, p, **f32)
    norms = torch.empty(b, nc, h, p, **f32)
    chunk_lf = torch.empty(b, nc, h, **f32)
    m_state = torch.empty(b, nc, h, **f32)
    outs = (y, n_intra, m_intra, states, norms, chunk_lf, m_state)
    if units == 0:
        return outs
    qp = -(-nq // TILE) * TILE
    w = torch.empty(units, qp, qp, **f32)          # the W scratch of pass 1
    lib = build()
    err = lib.mlstm_chunk_fwd(
        *(t.data_ptr() for t in ins + outs + (w,)), units, nq, h, p,
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.mlstm_chunk_error_string(err).decode()
        raise RuntimeError(f"mlstm_chunk launch failed: {msg}")
    LAUNCHES += 1
    return outs


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      li: torch.Tensor, lf: torch.Tensor, sm_scale: float
                      ) -> Outputs:
    """The kernel's plain PyTorch twin, in float32 on any device: the TPU
    kernel's math (``_mlstm_chunk_kernel``) for every (batch, chunk, head)
    at once.  Like the kernel, it sums lf_cum in float64 and keeps dmat,
    its row max, decay_end and m_state in float64 until the argument of
    exp is rounded to float32: at Q = 256 |lf_cum| reaches tens, and two
    float32 running sums in different orders would differ by ~1e-5 there.
    Above the diagonal dmat is the reference's finite -1e30, never -inf."""
    q, k, v, li, lf = (t.float() for t in (q, k, v, li, lf))
    nq = q.shape[2]
    cum = torch.cumsum(lf.double(), dim=2)               # (b,nc,Q,h) f64
    li64 = li.double()
    cum_h, li_h = cum.transpose(2, 3), li64.transpose(2, 3)   # (b,nc,h,Q)
    tri = torch.ones(nq, nq, dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(tri, cum_h[..., :, None] - cum_h[..., None, :]
                       + li_h[..., None, :],
                       torch.tensor(-1e30, dtype=torch.float64,
                                    device=q.device))    # (b,nc,h,Q,Q)
    m = dmat.amax(dim=-1)                                # (b,nc,h,Q)
    w = torch.exp((dmat - m[..., None]).float())
    scores = torch.einsum("bcihp,bcjhp->bchij", q * sm_scale, k)
    sw = scores * w
    y = torch.einsum("bchij,bcjhp->bcihp", sw, v)
    n_intra = sw.sum(dim=-1).transpose(2, 3).contiguous()
    m_intra = m.float().transpose(2, 3).contiguous()
    last = cum[:, :, -1]                                 # (b,nc,h)
    decay_end = last[:, :, None] - cum + li64            # (b,nc,Q,h)
    m_state = decay_end.amax(dim=2)                      # (b,nc,h)
    sk = torch.exp((decay_end - m_state[:, :, None]).float())
    states = torch.einsum("bcjhp,bcjhr->bchpr", k, v * sk[..., None])
    norms = torch.einsum("bcjhp,bcjh->bchp", k, sk)
    return (y, n_intra, m_intra, states, norms, last.float(),
            m_state.float())
