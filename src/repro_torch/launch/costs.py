"""Kernel-true accounting: the operations and HBM bytes of the four
hand-written kernels, per launch and per model step, on one card.

The kernels are ``ctypes`` calls, invisible to PyTorch's dispatch modes,
so the cost probe (``launch/probe.py``) runs the model in probe mode, with
every kernel bypassed, and adds these analytic terms back, as the
reference's ``launch/perf.py`` does for its Pallas kernels.

Per launch (the work one call's shapes need; each input read once, each
output written once):

* :func:`flash_launch` — flash attention forward, (B, Hq, Sq, D) queries
  against (B, Hkv, Skv, D) keys and values, the pairs a top-left causal
  mask keeps;
* :func:`ssd_launch` — the mamba2 SSD intra-chunk scan;
* :func:`mlstm_launch` — the mLSTM intra-chunk scan;
* :func:`swiglu_launch` — fused SwiGLU, silu(x Wg) * (x Wu), E experts.

Per model step (:func:`kernel_true_attention`, :func:`kernel_true_mlp`,
:func:`kernel_true_moe_ffn`, :func:`kernel_true_mixer`): the formulas of
``repro/launch/perf.py:49-152`` for one card, with no data-parallel
batch split and no tensor-parallel divisors.  They keep the reference's
model: a train step costs 3.5 forwards, attention is half masked, the
chunk is 256.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


# ---------------------------------------------------------------------------
# per launch
# ---------------------------------------------------------------------------

def flash_launch(case, dtype_name: str) -> Tuple[int, int]:
    """(operations, bytes) of one flash forward call on ``case`` = (B,
    Hq, Hkv, Sq, Skv, D, causal, ...): 4 D per (query, key) pair the mask
    keeps (q kᵀ and p v), and q, k, v and o once each."""
    b, hq, hkv, sq, skv, d, causal = case[:7]
    if causal:   # top-left: query row i sees keys 0..i
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    flops = 4 * d * b * hq * pairs
    nbytes = DTYPE_BYTES[dtype_name] * d * (2 * b * hq * sq
                                            + 2 * b * hkv * skv)
    return flops, nbytes


def ssd_launch(case) -> Tuple[int, int]:
    """(operations, bytes) of one SSD chunk call on ``case`` = (B, S, H, P,
    N, chunk): C Bᵀ (2 N per kept pair) once per (batch, chunk), the
    decay-weighted product with X (2 P per kept pair) and the state (2 Q N
    P) once per (batch, chunk, head); x, dt, A_log, B, C in and y, the
    states and the chunk log-decays out, in float32."""
    b, s, h, p, n, chunk = case
    q = min(chunk, s)
    nc = -(-s // q)
    ctas = b * nc * h
    pairs = q * (q + 1) // 2
    flops = b * nc * pairs * 2 * n + ctas * (pairs * 2 * p + 2 * q * n * p)
    floats = (2 * b * nc * q * h * p          # x, y
              + b * nc * q * h + h            # dt, A_log
              + 2 * b * nc * q * n            # B, C
              + ctas * n * p + ctas)          # states, chunk_lf
    return flops, 4 * floats


def mlstm_launch(case) -> Tuple[int, int]:
    """(operations, bytes) of one mLSTM chunk call on ``case`` = (B, S, H,
    P, chunk): per (batch, chunk, head) 2 P on each kept pair for q kᵀ and
    again for W v, 2 Q P² for the state and 2 Q P for its norm; q, k, v,
    the gate logits in and y, n, m, the states and norms out, in
    float32."""
    b, s, h, p, chunk = case
    q = min(chunk, s)
    nc = -(-s // q)
    units = b * nc * h
    pairs = q * (q + 1) // 2
    flops = units * (2 * pairs * 2 * p + 2 * q * p * p + 2 * q * p)
    rows = b * nc * q * h
    floats = (4 * rows * p                    # q, k, v, y_intra
              + 4 * rows                      # li, lf, n_intra, m_intra
              + units * (p * p + p + 2))      # states, norms, 2 scalars
    return flops, 4 * floats


def swiglu_launch(case, dtype_name: str) -> Tuple[int, int]:
    """(operations, bytes) of one fused SwiGLU call on ``case`` = (E, M, K,
    F): the two products' 4 E M K F, and x, Wg, Wu and h once each."""
    e, m, k, f = case
    flops = 4 * e * m * k * f
    nbytes = DTYPE_BYTES[dtype_name] * e * (m * k + 2 * k * f + m * f)
    return flops, nbytes


# ---------------------------------------------------------------------------
# per model step (the reference's kernel_true_*, one card)
# ---------------------------------------------------------------------------

def _mult(shape: ShapeConfig) -> float:
    return 3.5 if shape.kind == "train" else 1.0


def kernel_true_attention(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Flash-kernel FLOPs and HBM bytes of every attention layer of the
    step: q and o once, k and v streamed once per query block; causal
    halves both the FLOPs and the streaming; train is 3.5 forwards."""
    s = shape.seq_len
    b = shape.global_batch
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    causal = 0.5
    mult = _mult(shape)
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "audio":
        n_attn = cfg.n_layers * 2 + cfg.encoder_layers  # self+cross+enc
    if cfg.family == "vlm":
        n_attn = cfg.n_layers + cfg.n_layers // cfg.cross_attn_every
    flops = 4 * b * h * s * s * hd * causal * mult * n_attn
    nq = -(-s // cfg.block_q)
    bytes_ = ((2 * b * h * s * hd                      # q read + o write
               + 2 * b * hkv * s * hd * nq * causal) * 2  # k, v streams
              * mult * n_attn)
    return {"flops": float(flops), "bytes": float(bytes_)}


def kernel_true_mlp(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Fused-SwiGLU FLOPs and HBM bytes of every MLP of the step: 6 t d f
    (the three products) and x, the weights and h once each."""
    t = shape.global_batch * shape.seq_len
    d, f = cfg.d_model, cfg.d_ff
    mult = _mult(shape)
    n_mlp = cfg.n_layers
    if cfg.family == "hybrid":
        n_mlp = cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "audio":
        n_mlp = cfg.n_layers + cfg.encoder_layers
    flops = 6 * t * d * f * mult * n_mlp
    bytes_ = (2 * t * d + 3 * d * f + 2 * t * f) * 2 * mult * n_mlp
    return {"flops": float(flops), "bytes": float(bytes_)}


def kernel_true_moe_ffn(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """The fused expert FFN (one SwiGLU launch over every expert's
    capacity slots) of every MoE layer: groups of at most 4096 tokens,
    C = S_g k / E x capacity_factor slots per expert per group."""
    s_g = min(shape.seq_len, 4096)
    groups = max(shape.global_batch * (shape.seq_len // s_g), 1)
    e = cfg.n_experts
    cap = int(-(-s_g * cfg.top_k * cfg.capacity_factor // cfg.n_experts))
    d, f = cfg.d_model, cfg.moe_d_ff
    mult = _mult(shape)
    slots = groups * e * cap
    flops = 6 * slots * d * f * mult * cfg.n_layers
    bytes_ = (2 * slots * d + 3 * d * f * e + 2 * slots * f) * 2 \
        * mult * cfg.n_layers
    return {"flops": float(flops), "bytes": float(bytes_)}


def kernel_true_mixer(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """SSD (hybrid) or mLSTM (ssm) chunk-kernel FLOPs and HBM bytes of
    every mixer layer, at chunks of 256."""
    s = shape.seq_len
    b = shape.global_batch
    mult = _mult(shape)
    q = 256
    nc = -(-s // q)
    if cfg.family == "ssm":                      # mLSTM
        di = 2 * cfg.d_model
        h = cfg.n_heads
        p = di // h
        per_chunk_flops = 2 * q * q * p * 2 + 2 * q * p * p + 2 * q * p
        per_chunk_bytes = (3 * q * p + 2 * q + q * p + p * p) * 4
    else:                                        # mamba2 (zamba)
        di = cfg.d_inner
        h = cfg.n_ssm_heads
        p = di // h
        n = cfg.ssm_state or 64
        per_chunk_flops = 2 * q * q * n + 2 * q * q * p + 2 * q * n * p
        per_chunk_bytes = (2 * q * p + 2 * q * n + n * p) * 4
    n_mixer = cfg.n_layers
    flops = per_chunk_flops * nc * h * b * mult * n_mixer
    bytes_ = per_chunk_bytes * nc * h * b * mult * n_mixer
    return {"flops": float(flops), "bytes": float(bytes_)}


KERNEL_TRUE = {"attention": kernel_true_attention, "mlp": kernel_true_mlp,
               "moe_ffn": kernel_true_moe_ffn, "mixer": kernel_true_mixer}


def skipped_kernels(cfg: ModelConfig, kind: str) -> Tuple[str, ...]:
    """The kernel terms probe mode removes from a step of ``kind``: every
    attention, MLP, expert FFN and sequence mixer of a forward; in a
    decode step only the MLPs and expert FFNs (its attention and mixers
    are the decode paths, which launch no kernel and run in probe mode as
    they are)."""
    parts = []
    if kind != "decode" and cfg.family in ("dense", "moe", "hybrid",
                                           "audio", "vlm"):
        parts.append("attention")
    if cfg.is_moe:
        parts.append("moe_ffn")
    elif cfg.d_ff:
        parts.append("mlp")
    if kind != "decode" and cfg.family in ("hybrid", "ssm"):
        parts.append("mixer")
    return tuple(parts)


def kernel_true(cfg: ModelConfig, shape: ShapeConfig,
                parts: Iterable[str]) -> Dict:
    """The sum of the ``parts`` terms for the step ``shape`` (a decode
    step counts one token per sequence), with each term beside it."""
    if shape.kind == "decode":
        shape = ShapeConfig(shape.name, 1, shape.global_batch, "decode")
    terms = {p: KERNEL_TRUE[p](cfg, shape) for p in parts}
    return {"flops": sum(t["flops"] for t in terms.values()),
            "bytes": sum(t["bytes"] for t in terms.values()),
            "parts": terms}
