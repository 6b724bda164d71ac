"""Architecture + run configuration dataclasses."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture.  Field semantics follow the assignment table."""

    name: str
    family: str                   # dense | moe | ssm | audio | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0             # per-expert ffn width (0 -> d_ff)
    capacity_factor: float = 1.25

    # SSM (mamba2)
    moe_impl: str = "einsum"      # einsum (GShard one-hot) | gather (sort)

    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0            # mamba2 heads (0 -> d_inner // 64)

    # xLSTM
    slstm_every: int = 0          # 0 -> no sLSTM blocks; else every k-th block

    # Hybrid (zamba): shared attention block applied every k mamba blocks
    shared_attn_every: int = 0

    # Encoder-decoder (whisper): encoder config
    encoder_layers: int = 0
    encoder_seq: int = 0          # precomputed frame embeddings length (stub)

    # VLM: cross-attention every k layers; image token count (stub frontend)
    cross_attn_every: int = 0
    image_tokens: int = 0

    # Common
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # Attention implementation: naive | blockwise | pallas | skip (probe)
    attention_impl: str = "blockwise"
    # cost-probe differencing: bypass the SSD/mLSTM sequence mixer
    mixer_skip: bool = False
    # cost-probe differencing: bypass the MLP (fused-swiglu kernel cost
    # is added back analytically)
    mlp_skip: bool = False
    # cost-probe differencing: bypass the MoE expert FFN einsums only
    # (dispatch/combine kept; fused expert kernel cost added analytically)
    moe_ffn_skip: bool = False
    block_q: int = 512
    block_kv: int = 1024

    # Remat / memory planning.  ``offload`` enables the host-offload
    # eviction lane: budget-missing intermediates then get a joint
    # keep/recompute/offload decision priced by the hardware cost model
    # below (see repro.core.remat_policy.plan_joint_policy).
    remat: bool = True
    remat_budget_bytes: Optional[int] = None   # per-layer activation budget
    offload: bool = False
    dma_gbps: Optional[float] = None           # host-DMA GB/s (None = default)
    device_tflops: Optional[float] = None      # recompute TFLOP/s (None = default)

    # Parallelism
    pipeline_stages: int = 1

    # Cost-probe mode: python-unroll layer loops instead of lax.scan so
    # compiled.cost_analysis() counts every layer (XLA tallies while-loop
    # bodies once, which silently undercounts scanned stacks).
    unroll_layers: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(self.d_inner // 64, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.is_moe:
            mlp = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        else:
            mlp = 3 * d * self.d_ff if self.d_ff else 0
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            ssm = d * 2 * di + di * d + di * (self.ssm_state or 64) * 2
        if self.family == "ssm":  # xlstm mLSTM blocks
            di = 2 * d
            ssm = d * di * 3 + di * d
            mlp = 0
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            per_layer = ssm + 2 * d
        if self.family == "hybrid":
            # mamba blocks everywhere; shared attn counted once
            per_layer = ssm + 2 * d
            emb += attn + 3 * d * self.d_ff  # the single shared block
        total = emb + self.n_layers * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 3 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense_mlp = self.top_k * 3 * d * self.moe_d_ff + d * self.n_experts
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(emb + self.n_layers * (attn + dense_mlp + 2 * d))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: what step is lowered at which size."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatch: int = 0            # 0 -> no gradient accumulation

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs, per the assignment's skip rules."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention (skip per assignment)")
    return True, ""
