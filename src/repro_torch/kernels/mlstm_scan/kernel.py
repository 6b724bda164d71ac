"""mLSTM intra-chunk kernel on Hopper: build-and-launch wrappers, the
routing rule between them, and the plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/mlstm_scan/kernel.py:
mlstm_chunk_pallas``.  Two CUDA C++ sources for sm_90a, each compiled at
first use and loaded with ``ctypes`` by ``repro_torch.kernels._build``:

* ``csrc/mlstm_chunk_wgmma.cu``, variant ``"wgmma"``: every product on the
  tf32 tensor cores at fp32 accuracy (3xTF32), W kept in shared memory, the
  state in 128 x 128 tiles; for head dims that are multiples of 128 and
  chunks of 64..256 rows in whole 64-row tiles (xlstm-1.3b's p = 1024);
* ``csrc/mlstm_chunk.cu``, variant ``"simt"``: three passes of fp32 FMAs on
  the CUDA cores with W in a device-memory scratch; head dims that are
  multiples of 16 up to 1024 and chunks of 1..256 rows.

Each source's header says what bounds it on the H100 and how its design
answers that.  :func:`choose_variant` is the one routing rule;
:func:`mlstm_chunk` applies it and launches, and raises on what no kernel
takes; for CPU tensors it runs :func:`mlstm_chunk_plain`, the kernels'
plain PyTorch twin, which computes the TPU kernel's per (batch, chunk,
head) math for every unit at once.  ``LAUNCHES`` counts calls of a
kernel's entry point (a variant's two or three kernels are one launch
here) and ``LAUNCHES_BY_VARIANT`` splits them by variant, so a run can
show that its main path went through the kernel it should.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build

TILE = 64            # the simt kernel's tile; its W scratch is padded to it
MAX_CHUNK = 256      # one chunk row per thread in the kernels' scans
MAX_HEAD_DIM = 1024  # the simt kernel's largest head dim
WGMMA_TILE = 64      # the wgmma kernel's query and key tiles
WGMMA_SLICE = 128    # ... its v slices and state tiles: p a multiple of it

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "mlstm_chunk.cu"                # the "simt" variant
WGMMA_SOURCE = CSRC / "mlstm_chunk_wgmma.cu"    # the "wgmma" variant
SOURCES = {"wgmma": WGMMA_SOURCE, "simt": SOURCE}
VARIANTS = tuple(SOURCES)
# each variant's C entry point, its error-string function and its number
# of pointer arguments (the simt kernel takes its W scratch last)
_ENTRY = {"wgmma": ("mlstm_chunk_fwd_wgmma", "mlstm_chunk_wgmma_error_string",
                    12),
          "simt": ("mlstm_chunk_fwd", "mlstm_chunk_error_string", 13)}

LAUNCHES = 0          # kernel launches; set to 0 before a counted run
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

_libs: Dict[str, ctypes.CDLL] = {}

Outputs = Tuple[torch.Tensor, ...]


def reset_launches() -> None:
    """Set ``LAUNCHES`` and every ``LAUNCHES_BY_VARIANT`` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_VARIANT.update(dict.fromkeys(VARIANTS, 0))


def choose_variant(device_type: str, shape: Sequence[int],
                   misaligned: bool) -> str:
    """The kernel a call goes to: ``"plain"`` (the twin, CPU tensors only),
    ``"wgmma"`` or ``"simt"``.

    ``shape`` is (Q, p): chunk rows and head dim; ``misaligned`` says
    whether any input starts off a 16-byte boundary.  The wgmma kernel
    takes p a multiple of 128 and Q a multiple of 64 up to 256 (whole
    query and key tiles); the rest the simt kernel takes (p = 16..112 and
    other multiples of 16, chunks that are not whole tiles, offset views)
    goes to the simt kernel.
    """
    q, p = shape
    if device_type == "cpu":
        return "plain"
    if (misaligned or p % WGMMA_SLICE or p == 0 or q % WGMMA_TILE
            or not 0 < q <= MAX_CHUNK):
        return "simt"
    return "wgmma"


def variant_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                li: torch.Tensor, lf: torch.Tensor) -> str:
    """:func:`choose_variant` on the tensors of a call."""
    misaligned = q.device.type == "cuda" and any(
        t.data_ptr() % 16 for t in (q, k, v, li, lf))
    return choose_variant(q.device.type, (q.shape[2], q.shape[-1]),
                          misaligned)


def build(variant: str) -> ctypes.CDLL:
    """Compile the variant's source (once per source hash) and load it."""
    if variant in _libs:
        return _libs[variant]
    lib = _build.load(SOURCES[variant])
    fn_name, err_name, n_ptr = _ENTRY[variant]
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, err_name)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _libs[variant] = lib
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

    CUDA tensors go to the sm_90a kernel :func:`choose_variant` names, CPU
    tensors to the plain twin.  The kernels have no backward: the scan's
    is ``ops._MLSTMScan``'s recompute, so a CUDA call that would need a
    gradient here raises rather than return outputs the gradient cannot
    flow through.
    """
    _check(q, k, v, li, lf)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, li, lf, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, li, lf)):
        raise NotImplementedError(
            "mlstm_chunk is forward-only on the card; differentiate "
            "ops.mlstm_scan, whose backward recomputes mlstm_chunked")
    return _launch(q, k, v, li, lf, sm_scale, variant_for(q, k, v, li, lf))


def _launch(q, k, v, li, lf, sm_scale, variant: str) -> Outputs:
    """Launch ``variant`` on checked CUDA tensors.  The wrapper calls it
    with the variant :func:`choose_variant` picks; tests and
    ``chip_smoke.py`` may force one."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
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
    if variant == "wgmma" and choose_variant(
            "cuda", (nq, p), any(t.data_ptr() % 16 for t in ins)) != "wgmma":
        raise ValueError(f"the wgmma kernel takes p a multiple of "
                         f"{WGMMA_SLICE}, Q a multiple of {WGMMA_TILE} and "
                         f"16-byte aligned inputs, not Q={nq}, p={p}")
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
    ptrs = [t.data_ptr() for t in ins + outs]
    if variant == "simt":
        qp = -(-nq // TILE) * TILE
        w = torch.empty(units, qp, qp, **f32)      # the W scratch of pass 1
        ptrs.append(w.data_ptr())
    lib = build(variant)
    fn_name, err_name, _ = _ENTRY[variant]
    err = getattr(lib, fn_name)(
        *ptrs, units, nq, h, p, float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = getattr(lib, err_name)(err).decode()
        raise RuntimeError(f"mlstm_chunk launch failed ({variant}): {msg}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return outs


def mlstm_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      li: torch.Tensor, lf: torch.Tensor, sm_scale: float, *,
                      product: Callable = torch.einsum) -> Outputs:
    """The kernels' plain PyTorch twin, in float32 on any device: the TPU
    kernel's math (``_mlstm_chunk_kernel``) for every (batch, chunk, head)
    at once.  Like the kernel, it sums lf_cum in float64 and keeps dmat,
    its row max, decay_end and m_state in float64 until the argument of
    exp is rounded to float32: at Q = 256 |lf_cum| reaches tens, and two
    float32 running sums in different orders would differ by ~1e-5 there.
    Above the diagonal dmat is the reference's finite -1e30, never -inf.
    Its three matrix products (q kᵀ, W v, the state) go through
    ``product`` (an ``einsum``): the tests pass one that emulates the
    wgmma kernel's tf32 operand split; the norm stays a plain sum, as in
    the kernels."""
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
    scores = product("bcihp,bcjhp->bchij", q * sm_scale, k)
    sw = scores * w
    y = product("bchij,bcjhp->bcihp", sw, v)
    n_intra = sw.sum(dim=-1).transpose(2, 3).contiguous()
    m_intra = m.float().transpose(2, 3).contiguous()
    last = cum[:, :, -1]                                 # (b,nc,h)
    decay_end = last[:, :, None] - cum + li64            # (b,nc,Q,h)
    m_state = decay_end.amax(dim=2)                      # (b,nc,h)
    sk = torch.exp((decay_end - m_state[:, :, None]).float())
    states = product("bcjhp,bcjhr->bchpr", k, v * sk[..., None])
    norms = torch.einsum("bcjhp,bcjh->bchp", k, sk)
    return (y, n_intra, m_intra, states, norms, last.float(),
            m_state.float())
