"""Fused SwiGLU gate/up GEMM on Hopper: build-and-launch wrapper + plain
twin.

Replaces the Pallas TPU kernel ``repro/kernels/fused_swiglu/kernel.py:
fused_swiglu_pallas``.  The CUDA C++ source is ``csrc/fused_swiglu.cu``
(sm_90a); its header says what bounds it on the H100 and how the design
answers that.  It is compiled at first use and loaded with ``ctypes`` by
``repro_torch.kernels._build``.

:func:`fused_swiglu` launches that kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs
:func:`fused_swiglu_plain`, the kernel's plain PyTorch twin.  Both take an
optional leading batch (one MoE layer's experts: x (E, M, K), wg and wu
(E, K, F)), which the kernel runs in one launch.  ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the C entry point's codes

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_swiglu.cu"

LAUNCHES = 0          # kernel launches; set to 0 before a counted run

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/fused_swiglu.cu`` (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.fused_swiglu_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_swiglu_error_string.argtypes = [ctypes.c_int]
    lib.fused_swiglu_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> None:
    if x.dim() not in (2, 3) or wg.dim() != x.dim():
        raise ValueError(f"x {tuple(x.shape)} and wg {tuple(wg.shape)} must "
                         "be (M, K) and (K, F), or (E, M, K) and (E, K, F)")
    if wu.shape != wg.shape:
        raise ValueError(f"wu {tuple(wu.shape)} != wg {tuple(wg.shape)}")
    if wg.shape[:-2] != x.shape[:-2] or wg.shape[-2] != x.shape[-1]:
        raise ValueError(f"x {tuple(x.shape)} does not match wg "
                         f"{tuple(wg.shape)}")
    if x.dtype not in DTYPES or wg.dtype != x.dtype or wu.dtype != x.dtype:
        raise ValueError(f"x, wg, wu must all be float32 or all bfloat16, "
                         f"not {x.dtype}, {wg.dtype}, {wu.dtype}")
    if len({t.device for t in (x, wg, wu)}) != 1:
        raise ValueError("x, wg, wu must lie on one device")
    if not all(t.is_contiguous() for t in (x, wg, wu)):
        raise ValueError("x, wg, wu must be contiguous")


def fused_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
                 ) -> torch.Tensor:
    """h = silu(x wg) * (x wu), rounded once to x's dtype.

    x: (M, K), wg, wu: (K, F) -> (M, F); or x: (E, M, K), wg, wu:
    (E, K, F) -> (E, M, F).  Contiguous, all float32 or all bfloat16.
    CUDA tensors go to the sm_90a kernel, CPU tensors to the plain twin.
    """
    _check(x, wg, wu)
    if x.device.type == "cpu":
        return fused_swiglu_plain(x, wg, wu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, wg, wu)


def _launch(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
            ) -> torch.Tensor:
    global LAUNCHES
    batched = x.dim() == 3
    if not batched:
        x, wg, wu = x[None], wg[None], wu[None]
    e, m, k = x.shape
    f = wg.shape[-1]
    h = torch.empty(e, m, f, dtype=x.dtype, device=x.device)
    if h.numel():
        lib = build()
        err = lib.fused_swiglu_fwd(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(),
            e, m, k, f, m * k, k * f, m * f, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            msg = lib.fused_swiglu_error_string(err).decode()
            raise RuntimeError(f"fused_swiglu launch failed: {msg}")
        LAUNCHES += 1
    return h if batched else h[0]


def fused_swiglu_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's plain PyTorch twin, on any device: both products as
    fp32 matmuls, the silu * mul epilogue in fp32, one rounding to x's
    dtype."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    return (F.silu(g) * u).to(x.dtype)
