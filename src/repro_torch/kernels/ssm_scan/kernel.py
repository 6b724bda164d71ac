"""SSD (mamba2) intra-chunk scan on Hopper: build-and-launch wrappers, the
routing rule between them, and the plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan/kernel.py:
ssd_chunk_pallas``.  Two CUDA C++ sources for sm_90a, each compiled at
first use and loaded with ``ctypes`` by ``repro_torch.kernels._build``:

* ``csrc/ssd_chunk_wgmma.cu``, variant ``"wgmma"``: the three products on
  the tf32 tensor cores at fp32 accuracy (3xTF32: each operand split into
  two tf32 terms, three wgmmas a product), C Bᵀ computed once per group of
  8 heads; for state size and head dim 64 and chunks of 64..256 rows in
  whole 64-row tiles (zamba2-7b's mamba layers);
* ``csrc/ssd_chunk.cu``, variant ``"simt"``: fp32 FMAs on the CUDA cores,
  one CTA per (batch, chunk, head); widths 16, 32 and 64 and chunks of
  1..1024 rows.

Each source's header says what bounds it on the H100 and how its design
answers that.  :func:`choose_variant` is the one routing rule;
:func:`ssd_chunk` applies it and launches, and raises on what no kernel
takes; for CPU tensors it runs :func:`ssd_chunk_plain`, the kernels' plain
PyTorch twin, which computes the TPU kernel's per (batch, chunk, head)
math for all heads at once.  ``LAUNCHES`` counts kernel launches and
``LAUNCHES_BY_VARIANT`` splits them by variant, so a run can show that its
main path went through the kernel it should.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build

WIDTHS = (16, 32, 64)        # state size n and head dim p the kernels take
MAX_CHUNK = 1024             # the simt kernel's block scan covers 4 x 256 rows
WGMMA_WIDTH = 64             # the wgmma kernel's n and p
WGMMA_TILE = 64              # ... its query and key tiles
WGMMA_MAX_CHUNK = 256        # ... at most four of them

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ssd_chunk.cu"                  # the "simt" variant
WGMMA_SOURCE = CSRC / "ssd_chunk_wgmma.cu"      # the "wgmma" variant
SOURCES = {"wgmma": WGMMA_SOURCE, "simt": SOURCE}
VARIANTS = tuple(SOURCES)
# each variant's C entry point and its error-string function
_ENTRY = {"wgmma": ("ssd_chunk_fwd_wgmma", "ssd_chunk_wgmma_error_string"),
          "simt": ("ssd_chunk_fwd", "ssd_chunk_error_string")}

LAUNCHES = 0          # kernel launches; set to 0 before a counted run
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

_libs: Dict[str, ctypes.CDLL] = {}

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launches() -> None:
    """Set ``LAUNCHES`` and every ``LAUNCHES_BY_VARIANT`` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_VARIANT.update(dict.fromkeys(VARIANTS, 0))


def choose_variant(device_type: str, shape: Sequence[int],
                   misaligned: bool) -> str:
    """The kernel a call goes to: ``"plain"`` (the twin, CPU tensors only),
    ``"wgmma"`` or ``"simt"``.

    ``shape`` is (Q, n, p): chunk rows, state size, head dim;
    ``misaligned`` says whether any input starts off a 16-byte boundary.
    The wgmma kernel takes n = p = 64 and Q a multiple of 64 up to 256
    (whole query and key tiles, at most four); everything else the simt
    kernel takes (widths 16 and 32, ragged or longer chunks, offset
    views) goes to the simt kernel.
    """
    q, n, p = shape
    if device_type == "cpu":
        return "plain"
    if (misaligned or n != WGMMA_WIDTH or p != WGMMA_WIDTH
            or q % WGMMA_TILE or not 0 < q <= WGMMA_MAX_CHUNK):
        return "simt"
    return "wgmma"


def variant_for(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor) -> str:
    """:func:`choose_variant` on the tensors of a call."""
    misaligned = x.device.type == "cuda" and any(
        t.data_ptr() % 16 for t in (x, dt, A_log, B, C))
    return choose_variant(x.device.type,
                          (x.shape[2], B.shape[-1], x.shape[-1]), misaligned)


def build(variant: str) -> ctypes.CDLL:
    """Compile the variant's source (once per source hash) and load it."""
    if variant in _libs:
        return _libs[variant]
    lib = _build.load(SOURCES[variant])
    fn_name, err_name = _ENTRY[variant]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, err_name)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _libs[variant] = lib
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

    CUDA tensors go to the sm_90a kernel :func:`choose_variant` names, CPU
    tensors to the plain twin.  The kernels have no backward: the scan's
    is ``ops._SSDScan``'s recompute, so a CUDA call that would need a
    gradient here raises rather than return outputs the gradient cannot
    flow through.
    """
    _check(x, dt, A_log, B, C)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A_log, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A_log, B, C)):
        raise NotImplementedError(
            "ssd_chunk is forward-only on the card; differentiate "
            "ops.ssd_scan, whose backward recomputes ssd_chunked")
    return _launch(x, dt, A_log, B, C, variant_for(x, dt, A_log, B, C))


def _launch(x, dt, A_log, B, C, variant: str) -> Outputs:
    """Launch ``variant`` on checked CUDA tensors.  The wrapper calls it
    with the variant :func:`choose_variant` picks; tests and
    ``chip_smoke.py`` may force one."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
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
    if variant == "wgmma" and choose_variant(
            "cuda", (q, n, p), any(t.data_ptr() % 16 for t in ins)) \
            != "wgmma":
        raise ValueError(f"the wgmma kernel takes n = p = {WGMMA_WIDTH}, "
                         f"Q a multiple of {WGMMA_TILE} up to "
                         f"{WGMMA_MAX_CHUNK} and 16-byte aligned inputs, "
                         f"not Q={q}, n={n}, p={p}")
    if b * nc * h >= 2 ** 31:
        raise ValueError("grid too large")
    y = torch.empty_like(x)
    states = torch.empty(b, nc, h, n, p, dtype=torch.float32,
                         device=x.device)
    chunk_lf = torch.empty(b, nc, h, dtype=torch.float32, device=x.device)
    if b * nc * h == 0:
        return y, states, chunk_lf
    lib = build(variant)
    fn_name, err_name = _ENTRY[variant]
    # the simt kernel's grid is (batch, chunk, head), the wgmma kernel's
    # the (batch, chunk) pairs times its own tiles and head groups
    blocks = b * nc * h if variant == "simt" else b * nc
    err = getattr(lib, fn_name)(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), states.data_ptr(), chunk_lf.data_ptr(),
        blocks, q, h, n, p,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = getattr(lib, err_name)(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed ({variant}): {msg}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return y, states, chunk_lf


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *,
                    product: Callable = torch.einsum) -> Outputs:
    """The kernels' plain PyTorch twin, in float32 on any device: the TPU
    kernel's math (``_ssd_chunk_kernel``) for every (batch, chunk, head)
    at once.  L is a select, as in the reference: exp above the diagonal
    may overflow, and inf * 0 would be NaN.  Like the kernels, it sums
    dA_cum in float64 (see :func:`log_decay`).  Its three matrix products
    go through ``product`` (an ``einsum``): the tests pass one that
    emulates the wgmma kernel's tf32 operand split.  It is a forward
    oracle: its backward is not finite, since the select's zero cotangent
    above the diagonal meets the exp's inf there (0 * inf = NaN)."""
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    q = x.shape[2]
    cum = log_decay(dt, A_log)                           # (b,nc,Q,h) f64
    cum_h = cum.transpose(2, 3)                          # (b,nc,h,Q)
    seg = (cum_h[..., :, None] - cum_h[..., None, :]).float()
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(seg), torch.zeros((), device=x.device))
    scores = product("bcin,bcjn->bcij", C, B)       # (b,nc,Q,Q)
    w = scores[:, :, None] * L * dt.transpose(2, 3)[..., None, :]
    y = product("bchij,bcjhp->bcihp", w, x)         # (b,nc,Q,h,p)
    decay_e = torch.exp((cum[:, :, -1:] - cum).float())  # (b,nc,Q,h)
    xw = x * (dt * decay_e)[..., None]
    states = product("bcjn,bcjhp->bchnp", B, xw)    # (b,nc,h,n,p)
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
