"""Fused SwiGLU gate/up GEMM on Hopper: build-and-launch wrappers, the
routing rule between them, and the plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/fused_swiglu/kernel.py:
fused_swiglu_pallas``.  Two CUDA C++ sources for sm_90a, each compiled at
first use and loaded with ``ctypes`` by ``repro_torch.kernels._build``:

* ``csrc/fused_swiglu_wgmma.cu``, variant ``"wgmma"``: bf16 through wgmma
  on TMA-loaded, 128-byte-swizzled tiles, a producer warpgroup feeding two
  consumer warpgroups, a persistent grid over 128 x 128 tiles of h;
* ``csrc/fused_swiglu.cu``: variant ``"mma_sync"`` (bf16 through
  mma.sync and a cp.async ring, for rows TMA cannot describe) and variant
  ``"simt"`` (fp32 FMAs on the CUDA cores: the fp32 tolerance rules out
  tensor cores).

Each source's header says what bounds it on the H100 and how its design
answers that.  :func:`choose_variant` is the one routing rule;
:func:`fused_swiglu` applies it and launches, and raises on what no
kernel takes; for CPU tensors it runs :func:`fused_swiglu_plain`, the
kernels' plain PyTorch twin; its backward recomputes the twin under
autograd.  All take an optional leading batch (one MoE layer's experts:
x (E, M, K), wg and wu (E, K, F)), run in one launch.
``LAUNCHES`` counts kernel launches and ``LAUNCHES_BY_VARIANT`` splits them
by variant, so a run can show that its main path went through the kernel
it should.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.remat import produce
from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the C entry point's codes

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "fused_swiglu.cu"               # "mma_sync" and "simt"
WGMMA_SOURCE = CSRC / "fused_swiglu_wgmma.cu"   # "wgmma"
SOURCES = {"wgmma": WGMMA_SOURCE, "mma_sync": SOURCE, "simt": SOURCE}
VARIANTS = tuple(SOURCES)

LAUNCHES = 0          # kernel launches; set to 0 before a counted run
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

# csrc/fused_swiglu_wgmma.cu: BM, BN, BK, STAGES and SMEM_ALLOC
WGMMA_BM, WGMMA_BN, WGMMA_BK, WGMMA_STAGES = 128, 128, 64, 4
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set ``LAUNCHES`` and every ``LAUNCHES_BY_VARIANT`` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_VARIANT.update(dict.fromkeys(VARIANTS, 0))


def wgmma_smem_bytes() -> int:
    """Dynamic shared memory of the wgmma kernel (``SMEM_ALLOC``): per
    stage the x tile and the Wg and Wu tiles, a full and an empty barrier
    per stage, and 1 KB to align the base to 1024 bytes."""
    stage = WGMMA_BM * WGMMA_BK * 2 + 2 * WGMMA_BK * WGMMA_BN * 2
    return WGMMA_STAGES * stage + 2 * WGMMA_STAGES * 8 + 1024


def choose_variant(device_type: str, dtype: torch.dtype,
                   shape: Sequence[int], misaligned: bool) -> str:
    """The kernel a call goes to: ``"plain"`` (the twin, CPU tensors only),
    ``"wgmma"``, ``"mma_sync"`` or ``"simt"``.

    ``shape`` is (E, M, K, F); ``misaligned`` says whether any of x, wg,
    wu starts off a 16-byte boundary.  fp32 goes to the SIMT kernel.  bf16
    goes to the wgmma kernel when TMA can describe the rows (16-byte
    aligned bases, K and F multiples of 8, K > 0), otherwise to the
    mma_sync kernel.  M does not enter: at decode's M = 4 the wgmma
    kernel was measured no slower than the mma_sync one (PERF.md).
    """
    k, f = shape[2:]
    if device_type == "cpu":
        return "plain"
    if dtype != torch.bfloat16:
        return "simt"
    if misaligned or k == 0 or k % 8 or f % 8:
        return "mma_sync"
    return "wgmma"


def variant_for(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> str:
    """:func:`choose_variant` on the tensors of a call."""
    shape = (x.shape[0] if x.dim() == 3 else 1, x.shape[-2], x.shape[-1],
             wg.shape[-1])
    misaligned = x.device.type == "cuda" and any(
        t.data_ptr() % 16 for t in (x, wg, wu))
    return choose_variant(x.device.type, x.dtype, shape, misaligned)


def build(variant: str) -> ctypes.CDLL:
    """Compile the variant's source (once per source hash) and load it."""
    source = SOURCES[variant]
    if source.name in _libs:
        return _libs[source.name]
    lib = _build.load(source)
    if source == SOURCE:
        fn, err = lib.fused_swiglu_fwd, lib.fused_swiglu_error_string
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    else:
        fn, err = lib.fused_swiglu_fwd_wgmma, \
            lib.fused_swiglu_wgmma_error_string
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _libs[source.name] = lib
    return lib


def _check(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> None:
    _build.require_local(x, wg, wu)
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
    """h = silu(x wg) * (x wu), rounded once to x's dtype, differentiable.

    x: (M, K), wg, wu: (K, F) -> (M, F); or x: (E, M, K), wg, wu:
    (E, K, F) -> (E, M, F).  Contiguous, all float32 or all bfloat16.
    The forward goes to the sm_90a kernel :func:`choose_variant` names for
    CUDA tensors and to the plain twin for CPU tensors; the backward
    recomputes the twin under autograd (:class:`_FusedSwiGLU`).
    """
    _check(x, wg, wu)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wg, wu)):
        return _FusedSwiGLU.apply(x, wg, wu)
    return _forward(x, wg, wu)


def _forward(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
             ) -> torch.Tensor:
    if x.device.type == "cpu":
        return fused_swiglu_plain(x, wg, wu)
    return _launch(x, wg, wu, variant_for(x, wg, wu))


class _FusedSwiGLU(torch.autograd.Function):
    """Forward by the kernel; backward by the plain twin's autograd, as the
    reference's models differentiate the plain ``layers.swiglu``.  It saves
    only x, wg and wu, so a checkpoint replay that kept h skips the kernel
    (:func:`repro_torch.core.remat.produce`).  For bf16 inputs on the card
    the twin's fp32 products may run on tf32 tensor cores: a bf16 operand
    is exact in tf32, and the gradients are rounded to bf16."""

    @staticmethod
    def forward(ctx, x, wg, wu):
        ctx.save_for_backward(x, wg, wu)
        return produce(lambda: _forward(x, wg, wu))

    @staticmethod
    def backward(ctx, dh):
        x, wg, wu = ctx.saved_tensors
        inputs = tuple(t.detach().requires_grad_(t.requires_grad)
                       for t in (x, wg, wu))
        need = [t for t in inputs if t.requires_grad]
        tf32 = x.device.type == "cuda" and x.dtype == torch.bfloat16
        with torch.enable_grad(), _allow_tf32(tf32):
            h = fused_swiglu_plain(*inputs)
            got = iter(torch.autograd.grad(h, need, dh))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


@contextlib.contextmanager
def _allow_tf32(on: bool):
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = before or on
    try:
        yield
    finally:
        flags.allow_tf32 = before


def _launch(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            variant: str) -> torch.Tensor:
    """Launch ``variant`` on checked CUDA tensors.  The wrapper calls it
    with the variant :func:`choose_variant` picks; tests and
    ``chip_smoke.py`` may force one."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if (variant == "simt") != (x.dtype == torch.float32):
        raise ValueError(f"variant {variant!r} does not take {x.dtype}")
    k, f = x.shape[-1], wg.shape[-1]
    if variant == "wgmma" and (k == 0 or k % 8 or f % 8 or any(
            t.data_ptr() % 16 for t in (x, wg, wu))):
        raise ValueError("the wgmma kernel takes 16-byte aligned bases and "
                         "K, F multiples of 8, K > 0")
    batched = x.dim() == 3
    if not batched:
        x, wg, wu = x[None], wg[None], wu[None]
    e, m = x.shape[:2]
    h = torch.empty(e, m, f, dtype=x.dtype, device=x.device)
    if h.numel():
        lib = build(variant)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == "wgmma":
            err = lib.fused_swiglu_fwd_wgmma(
                x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(),
                e, m, k, f, stream)
            errstr = lib.fused_swiglu_wgmma_error_string
        else:
            err = lib.fused_swiglu_fwd(
                x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(),
                e, m, k, f, m * k, k * f, m * f, DTYPES[x.dtype], stream)
            errstr = lib.fused_swiglu_error_string
        if err != 0:
            msg = errstr(err).decode()
            raise RuntimeError(f"fused_swiglu launch failed: {msg}")
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[variant] += 1
    return h if batched else h[0]


def fused_swiglu_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's plain PyTorch twin, on any device: both products as
    fp32 matmuls, the silu * mul epilogue in fp32, one rounding to x's
    dtype."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    return (F.silu(g) * u).to(x.dtype)
