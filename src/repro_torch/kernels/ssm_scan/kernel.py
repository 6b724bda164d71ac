"""SSD (mamba2) intra-chunk scan on Hopper: build-and-launch wrapper + plain
twin.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan/kernel.py:
ssd_chunk_pallas``.  The CUDA C++ source is ``csrc/ssd_chunk.cu`` (sm_90a);
its header says what bounds it on the H100 and how the design answers
that.  It is compiled at first use and loaded with ``ctypes`` by
``repro_torch.kernels._build``.

:func:`ssd_chunk` launches that kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs :func:`ssd_chunk_plain`,
the kernel's plain PyTorch twin, which computes the TPU kernel's per
(batch, chunk, head) math for all heads at once.  ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

WIDTHS = (16, 32, 64)        # state size n and head dim p the kernel takes
MAX_CHUNK = 1024             # the kernel's block scan covers 4 x 256 rows

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"

LAUNCHES = 0          # kernel launches; set to 0 before a counted run

_lib: Optional[ctypes.CDLL] = None

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build() -> ctypes.CDLL:
    """Compile ``csrc/ssd_chunk.cu`` (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.ssd_chunk_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_chunk_error_string.argtypes = [ctypes.c_int]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(x, dt, A_log, B, C) -> None:
    if x.dim() != 5:
        raise ValueError("x must be (b, nc, Q, h, p)")
    b, nc, q, h, _ = x.shape
    if dt.shape != (b, nc, q, h):
        raise ValueError(f"dt {tuple(dt.shape)} != {(b, nc, q, h)}")
    if A_log.shape != (h,):
        raise ValueError(f"A_log {tuple(A_log.shape)} != {(h,)}")
    if B.dim() != 4 or B.shape[:3] != (b, nc, q) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must "
                         f"be ({b}, {nc}, {q}, n)")
    if len({t.device for t in (x, dt, A_log, B, C)}) != 1:
        raise ValueError("x, dt, A_log, B, C must lie on one device")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor) -> Outputs:
    """Intra-chunk SSD.

    x: (b, nc, Q, h, p); dt: (b, nc, Q, h); A_log: (h,); B, C: (b, nc, Q, n)
    -> (y_diag (b, nc, Q, h, p), states (b, nc, h, n, p),
        chunk_lf (b, nc, h)), all float32.

    CUDA tensors go to the sm_90a kernel, CPU tensors to the plain twin.
    """
    _check(x, dt, A_log, B, C)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A_log, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, dt, A_log, B, C)


def _launch(x, dt, A_log, B, C) -> Outputs:
    global LAUNCHES
    b, nc, q, h, p = x.shape
    n = B.shape[-1]
    ins = (x, dt, A_log, B, C)
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError("the kernel takes float32 inputs")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("the kernel takes contiguous inputs")
    if n not in WIDTHS or p not in WIDTHS:
        raise ValueError(f"the kernel takes n and p in {WIDTHS}, "
                         f"not n={n}, p={p}")
    if not 1 <= q <= MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of 1..{MAX_CHUNK} rows, "
                         f"not {q}")
    n_blocks = b * nc * h
    if n_blocks >= 2 ** 31:
        raise ValueError("grid too large")
    y = torch.empty_like(x)
    states = torch.empty(b, nc, h, n, p, dtype=torch.float32,
                         device=x.device)
    chunk_lf = torch.empty(b, nc, h, dtype=torch.float32, device=x.device)
    if n_blocks == 0:
        return y, states, chunk_lf
    lib = build()
    err = lib.ssd_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), states.data_ptr(), chunk_lf.data_ptr(),
        n_blocks, q, h, n, p,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: {msg}")
    LAUNCHES += 1
    return y, states, chunk_lf


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor) -> Outputs:
    """The kernel's plain PyTorch twin, in float32 on any device: the TPU
    kernel's math (``_ssd_chunk_kernel``) for every (batch, chunk, head)
    at once.  L is a select, as in the reference: exp above the diagonal
    may overflow, and inf * 0 would be NaN.  Like the kernel, it sums
    dA_cum in float64 (see :func:`log_decay`)."""
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    q = x.shape[2]
    cum = log_decay(dt, A_log)                           # (b,nc,Q,h) f64
    cum_h = cum.transpose(2, 3)                          # (b,nc,h,Q)
    seg = (cum_h[..., :, None] - cum_h[..., None, :]).float()
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(seg), torch.zeros((), device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", C, B)       # (b,nc,Q,Q)
    w = scores[:, :, None] * L * dt.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchij,bcjhp->bcihp", w, x)         # (b,nc,Q,h,p)
    decay_e = torch.exp((cum[:, :, -1:] - cum).float())  # (b,nc,Q,h)
    xw = x * (dt * decay_e)[..., None]
    states = torch.einsum("bcjn,bcjhp->bchnp", B, xw)    # (b,nc,h,n,p)
    return y, states, cum[:, :, -1].float()


def log_decay(dt: torch.Tensor, A_log: torch.Tensor) -> torch.Tensor:
    """dA_cum = cumsum(dt * -exp(A_log)) over the chunk axis (2), summed in
    float64.  In float32, a chunk of 256 rows takes |dA_cum| to hundreds,
    where the rounding of the running sum (~1e-4 absolute) becomes a ~1e-4
    relative error in L = exp(dA_cum_i - dA_cum_j) next to the diagonal;
    two float32 sums in different orders (the kernel's block scan,
    ``torch.cumsum``) then disagree by more than the kernel tests' 1e-4.
    Summed in float64, both give the same float32 differences."""
    dA = dt.float() * -torch.exp(A_log.float())          # float32 products
    return torch.cumsum(dA.double(), dim=2)
