"""Flash-attention forward on Hopper: build-and-launch wrappers, the
routing rule between them, and the plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py:
flash_attention_fwd``.  Two CUDA C++ sources for sm_90a, each compiled at
first use and loaded with ``ctypes`` by ``repro_torch.kernels._build``:

* ``csrc/flash_fwd_wgmma.cu``, variant ``"wgmma"``: bf16 through wgmma on
  TMA-loaded, 128-byte-swizzled tiles, a producer warpgroup feeding two
  consumer warpgroups (128 query rows x tiles of 96 or 128 keys);
* ``csrc/flash_fwd.cu``, variant ``"simt"``: fp32 FMAs on the CUDA cores
  (64 x 64 tiles); it takes fp32, whose tolerance no tensor-core rate
  meets, and bf16 views TMA cannot describe.

Each source's header says what bounds it on the H100 and how its design
answers that.  :func:`choose_variant` is the one routing rule;
:func:`flash_attention_fwd` applies it and launches, and raises on what
no kernel takes; for CPU tensors it runs :func:`flash_attention_fwd_plain`,
the kernels' plain PyTorch twin, which repeats the TPU kernel's schedule
(q blocks x kv blocks, online softmax, blocks above the causal diagonal
skipped) in fp32.  ``LAUNCHES`` counts kernel launches and
``LAUNCHES_BY_VARIANT`` splits them by variant, so a run can show that its
main path went through the kernel it should.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Sequence

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_fwd.cu"                  # the "simt" variant
WGMMA_SOURCE = CSRC / "flash_fwd_wgmma.cu"      # the "wgmma" variant
SOURCES = {"wgmma": WGMMA_SOURCE, "simt": SOURCE}
VARIANTS = tuple(SOURCES)

LAUNCHES = 0          # kernel launches; set to 0 before a counted run
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

# csrc/flash_fwd_wgmma.cu: BLOCK_M, STAGES and Layout<DP>
WGMMA_BLOCK_M = 128
WGMMA_STAGES = 3
SMEM_LIMIT = 232_448          # bytes of shared memory a block may use

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set ``LAUNCHES`` and every ``LAUNCHES_BY_VARIANT`` count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_VARIANT.update(dict.fromkeys(VARIANTS, 0))


def padded_head_dim(d: int) -> int:
    """The wgmma kernel's head dim: D padded to whole 64-column boxes."""
    return 64 if d <= 64 else 128


def wgmma_block_n(d: int) -> int:
    """Keys per K/V tile of the wgmma kernel (``Layout<DP>::BN``): 128 at
    DP = 64, 96 at DP = 128, so S, P and O fit a consumer's registers."""
    return 128 if padded_head_dim(d) == 64 else 96


def wgmma_smem_bytes(d: int) -> int:
    """Dynamic shared memory of the wgmma kernel at head dim ``d``
    (``Layout<DP>::ALLOC``): the Q tile, ``WGMMA_STAGES`` K and V tiles,
    one full barrier for Q, a full barrier each for K and V and an empty
    barrier per stage, and 1 KB to align the base to 1024 bytes."""
    dp = padded_head_dim(d)
    q = WGMMA_BLOCK_M * dp * 2
    kv = wgmma_block_n(d) * dp * 2
    return q + 2 * WGMMA_STAGES * kv + (1 + 3 * WGMMA_STAGES) * 8 + 1024


def choose_variant(device_type: str, dtype: torch.dtype, head_dim: int,
                   strides: Sequence[int], misaligned: bool) -> str:
    """The kernel a call goes to: ``"plain"`` (the twin, CPU tensors only),
    ``"wgmma"`` or ``"simt"``.

    ``strides`` are the element strides of q, k and v over batch, head and
    seq (dims of size 1 left out: their stride is never used);
    ``misaligned`` says whether any of their base addresses is off a
    16-byte boundary.  bf16 goes to the wgmma kernel when TMA can describe
    the tensors (16-byte aligned bases, strides of whole 16 bytes); every
    other CUDA call, fp32 included, to the SIMT kernel.
    """
    if device_type == "cpu":
        return "plain"
    if dtype != torch.bfloat16 or head_dim not in HEAD_DIMS or misaligned:
        return "simt"
    if any((s * 2) % 16 for s in strides):
        return "simt"
    return "wgmma"


def variant_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """:func:`choose_variant` on the tensors of a call."""
    strides = [st for t in (q, k, v)
               for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    misaligned = q.device.type == "cuda" and any(
        t.data_ptr() % 16 for t in (q, k, v))
    return choose_variant(q.device.type, q.dtype, q.shape[-1], strides,
                          misaligned)


def build(variant: str) -> ctypes.CDLL:
    """Compile the variant's source (once per source hash) and load it."""
    if variant in _libs:
        return _libs[variant]
    lib = _build.load(SOURCES[variant])
    if variant == "simt":
        fn, err = lib.flash_attention_fwd, lib.flash_attention_error_string
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    else:
        fn = lib.flash_attention_fwd_wgmma
        err = lib.flash_attention_wgmma_error_string
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    _libs[variant] = lib
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _build.require_local(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError("GQA requires q_heads % kv_heads == 0")
    if k.shape[2] == 0:
        raise ValueError("no keys to attend to")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must lie on one device")
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("q, k, v must share one dtype")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, block_q: int = 512,
                        block_kv: int = 1024) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    CUDA tensors go to the sm_90a kernel :func:`choose_variant` names
    (each with its own tiles: 128 x 96 or 128 x 128 for wgmma, 64 x 64 for
    simt; the
    ``block_*`` sizes are the TPU kernel's VMEM tiling and shape only the
    plain twin).  CPU tensors go to the plain twin.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, causal, variant_for(q, k, v))


def _tma_strides(t: torch.Tensor) -> list:
    """t's (batch, head, seq) element strides, a dim of size 1 given the
    tensor's span rounded up to 8 elements (its stride is never used, and
    TMA wants every stride a multiple of 16 bytes)."""
    span = max(st * n for st, n in zip(t.stride(), t.shape))
    fill = -(-span // 8) * 8
    return [st if n > 1 else fill
            for st, n in zip(t.stride()[:3], t.shape[:3])]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, variant: str) -> torch.Tensor:
    """Launch ``variant`` on CUDA tensors.  The wrapper calls it with the
    variant :func:`choose_variant` picks; tests and ``chip_smoke.py`` may
    force one."""
    global LAUNCHES
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if q.dtype not in DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, not {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension must be contiguous")
    if b * hq >= 2 ** 31 or -(-sq // 64) > 65535:
        raise ValueError("grid too large")
    if variant == "wgmma" and variant_for(q, k, v) != "wgmma":
        raise ValueError("the wgmma kernel takes bf16 with 16-byte aligned "
                         "bases and strides")
    out = torch.empty_like(q)      # keeps q's layout, e.g. (B, S, H, D)
    if sq == 0:
        return out
    lib = build(variant)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "wgmma":
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v) for s in _tma_strides(t)),
            *out.stride()[:3])
        err = lib.flash_attention_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, hq, hkv, sq, skv, d, 1.0 / math.sqrt(d),
            int(causal), stream)
        if err != 0:
            msg = lib.flash_attention_wgmma_error_string(err).decode()
            raise RuntimeError(f"flash_attention_fwd launch failed: {msg}")
    else:
        strides = (ctypes.c_longlong * 12)(
            *(s for t in (q, k, v, out) for s in t.stride()[:3]))
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, hq, hkv, sq, skv, d, 1.0 / math.sqrt(d),
            int(causal), int(q.dtype == torch.bfloat16), stream)
        if err != 0:
            msg = lib.flash_attention_error_string(err).decode()
            raise RuntimeError(f"flash_attention_fwd launch failed: {msg}")
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    return out


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              block_q: int = 512, block_kv: int = 1024
                              ) -> torch.Tensor:
    """The kernel's plain PyTorch twin: the TPU kernel's tiled online
    softmax in fp32, top-left causal mask, on any device."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    groups = hq // hkv
    scale = 1.0 / math.sqrt(d)
    block_q = min(block_q, sq)
    block_kv = min(block_kv, skv)
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    out = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        q_pos = torch.arange(q0, q0 + qb.shape[2], device=q.device)
        acc = torch.zeros_like(qb)
        m = torch.full(qb.shape[:3] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, skv, block_kv):
            if causal and k0 > q0 + block_q - 1:
                break           # kv blocks strictly above the diagonal
            kb = kf[:, :, k0:k0 + block_kv]
            vb = vf[:, :, k0:k0 + block_kv]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if causal:
                k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p @ vb
            m = m_new
        out[:, :, q0:q0 + block_q] = acc / l.clamp_min(1e-30)
    return out.to(q.dtype)
