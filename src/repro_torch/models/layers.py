"""Shared neural-net layers as plain functions on tensors.

Port of ``repro/models/layers.py``.  Every matmul casts to the config's
compute dtype, as the reference does at each use; a served model may hold
matmul weights in that dtype already, which makes the cast a no-op (a
trained one holds them in float32).  Norm scales stay float32.  ``tag``
names an intermediate for a checkpointed block's policy
(``repro_torch.core.remat``), as the reference's does.  Under a mesh
(``repro_torch.sharding``) a parameter is read through
``collectives.fetch`` (its FSDP shards gathered); the SwiGLU MLP whose
placement splits ``mlp`` over ``model`` computes its own columns and sums
its partial products, and an embedding split over the vocabulary looks up
its own rows: the reference's ``constrain`` sites as explicit local
compute.  Without a mesh every function computes what it does on one
device.

Every random draw takes a ``torch.Generator``; the tensor lands on the
generator's device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.remat_policy import tag
from repro_torch.kernels.fused_swiglu.ops import fused_swiglu
from repro_torch.sharding import collectives as C

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def weight_dtype(cfg, trainable: bool) -> torch.dtype:
    """The dtype matmul weights and the embedding are held in: the
    compute dtype to serve, ``param_dtype`` (float32) to train."""
    return dtype_of(cfg.param_dtype if trainable else cfg.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, *, device) -> torch.Tensor:
    return torch.ones(d, dtype=torch.float32, device=device)


def rmsnorm_specs():
    """Logical axes of a norm scale (the reference's ``{"scale": ...}``;
    the port holds the scale itself)."""
    return ("embed",)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5, *,
            ways: int = 1) -> torch.Tensor:
    """``ways`` > 1: ``x``'s last dim is this rank's block of one of as
    many equal blocks split over ``model``, and the variance is the mean
    over all of them (the ranks' means summed: ``C.shared_sum``)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    if ways > 1:
        var = C.shared_sum(var, "model") / ways
    return (xf * torch.rsqrt(var + eps) * C.fetch(scale)).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / embedding
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype) -> torch.Tensor:
    """A ``shape`` tensor ~ N(0, std^2), drawn in float32 on the
    generator's device, held in ``dtype``."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) kernel ~ N(0, 1/d_in), drawn in float32."""
    return normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


def dense_specs(in_axis, out_axis):
    """Logical axes of a (d_in, d_out) kernel."""
    return (in_axis, out_axis)


def dense(kernel: torch.Tensor, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return x.to(compute_dtype) @ kernel.to(compute_dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(vocab, d) table ~ N(0, 0.02^2), drawn in float32."""
    return normal(gen, (vocab, d), 0.02, dtype)


def embedding_specs():
    return ("vocab", "embed")


def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The rows of ``tokens``.  A table whose placement splits the
    vocabulary over ``model`` holds a block of rows: each rank looks up
    the tokens inside its block, zeros the others, and the blocks' rows
    are summed over ``model``."""
    if not C.split_over(table, 0):
        return F.embedding(tokens, C.fetch(table)).to(compute_dtype)
    rows = C.fetch(table)
    local = tokens - C.block_start(table, 0)
    inside = (local >= 0) & (local < rows.shape[0])
    found = F.embedding(local.clamp(0, rows.shape[0] - 1), rows) \
        * inside[..., None].to(rows.dtype)
    return C.reduce_from(found).to(compute_dtype)


def unembed(table: torch.Tensor, x: torch.Tensor,
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Logits projection through a tied (V, d) table (this rank's
    vocabulary block of it under a mesh that splits it)."""
    return x.to(compute_dtype) @ C.fetch(table).to(compute_dtype).T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, *, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, (..., seq, 1, head_dim / 2) fp32."""
    freqs = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions[..., :, None].float() * freqs       # (..., s, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, d_ff: int, *,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    return {"gate": dense_init(gen, d, d_ff, dtype=dtype),
            "up": dense_init(gen, d, d_ff, dtype=dtype),
            "down": dense_init(gen, d_ff, d, dtype=dtype)}


def swiglu_specs():
    return {"gate": dense_specs("embed", "mlp"),
            "up": dense_specs("embed", "mlp"),
            "down": dense_specs("mlp", "embed")}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s formula, x * (1 / (1 + exp(-x))), rounded to the
    dtype after each step as the reference is (``F.silu`` rounds once, so
    its bf16 results differ from the reference's by an ulp in many
    elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), spelled out as ``lax.logaddexp``
    computes it, max(x, 0) + log1p(exp(-|x|)), rounded to the dtype after
    each step (``torch.logaddexp`` rounds once in bf16; ``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Prefix sums summed in float64 and rounded to ``x``'s dtype, as the
    SSD and mLSTM kernels sum theirs (``ssm_scan.kernel.log_decay``): at
    the SSD's 256-row log decays, which reach thousands, two float32
    orders of the sum disagree by more than 1e-4 in exp(sum_i - sum_j)."""
    return torch.cumsum(x.double(), dim).to(x.dtype)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``'s formula, -softplus(-x)."""
    return -softplus(-x)


def swiglu(params, x: torch.Tensor,
           compute_dtype: torch.dtype = torch.bfloat16, *,
           skip: bool = False) -> torch.Tensor:
    """down(silu(x gate) * (x up)).  The gate/up half is the fused SwiGLU
    kernel's function (``kernels/fused_swiglu``: the sm_90a kernel on the
    card, its plain twin on the CPU): fp32 products and epilogue, rounded
    once to the compute dtype, where the reference's op-by-op jnp rounds
    g, u and each step of silu (about an ulp of h apart in bf16).  The
    down projection stays a matmul, as the reference leaves it to XLA.
    Under a mesh that splits ``mlp`` over ``model``, each rank runs the
    kernel on its own columns of gate and up and its rows of down, and
    the partial products are summed over ``model``.

    ``skip`` is the reference's cost-probe mode (``cfg.mlp_skip``): x
    itself, the kernel's cost added analytically (``launch/costs.py``)."""
    if skip:
        return x
    dt = compute_dtype
    split = C.split_over(params["gate"], 1)
    if split:
        x = C.copy_to(x)
    h = fused_swiglu(x.to(dt), C.fetch(params["gate"]).to(dt),
                     C.fetch(params["up"]).to(dt))
    h = tag("mlp_hidden", h)
    out = dense(C.fetch(params["down"]), h, dt)
    return C.reduce_from(out) if split else out
