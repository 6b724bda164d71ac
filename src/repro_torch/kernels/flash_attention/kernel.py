"""Flash-attention forward on Hopper: build-and-launch wrapper + plain twin.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py:
flash_attention_fwd``.  The CUDA C++ source is ``csrc/flash_fwd.cu``
(sm_90a); its header says what bounds it on the H100 and how the design
answers that.  It is compiled at first use and loaded with ``ctypes`` by
``repro_torch.kernels._build``.

:func:`flash_attention_fwd` launches that kernel for CUDA tensors and
raises on anything it does not take; for CPU tensors it runs
:func:`flash_attention_fwd_plain`, the kernel's plain PyTorch twin, which
repeats the TPU kernel's schedule (q blocks x kv blocks, online softmax,
blocks above the causal diagonal skipped) in fp32.  ``LAUNCHES`` counts
kernel launches, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"

LAUNCHES = 0          # kernel launches; set to 0 before a counted run

_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/flash_fwd.cu`` (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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

    CUDA tensors go to the sm_90a kernel (its own 64 x 64 tiles; the
    ``block_*`` sizes are the TPU kernel's VMEM tiling and shape only the
    plain twin).  CPU tensors go to the plain twin.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         block_q=block_q, block_kv=block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, causal)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    global LAUNCHES
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, not {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension must be contiguous")
    if b * hq >= 2 ** 31 or -(-sq // 64) > 65535:
        raise ValueError("grid too large")
    out = torch.empty_like(q)      # keeps q's layout, e.g. (B, S, H, D)
    if sq == 0:
        return out
    lib = build()
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, hq, hkv, sq, skv, d, 1.0 / math.sqrt(d), int(causal),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg}")
    LAUNCHES += 1
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
