"""The model FLOPs of one train step, counted from a configuration's widths.

Forward products at every application, times 3 for the forward and the two
products of the backward; no replay of a checkpointed block is counted,
since it is work the memory plan chose and not work the model needs.

* attention: the q, k, v and o projections, and q kᵀ and p v on the pairs
  the causal mask keeps (half the square, diagonal included);
* a dense SwiGLU MLP: three products; an MoE layer: the router and the
  top-k experts' three products a token (no dispatch or combine products:
  they move tokens and are overhead of one implementation);
* a mamba2 layer: in_proj, the depthwise conv, the SSD scan's products
  (C Bᵀ on each chunk's kept pairs, once for the one group of B and C; the
  decay-weighted product with x and the chunk state per head; the
  inter-chunk term C h per head) and out_proj;
* zamba's shared block once per application (every ``shared_attn_every``
  mamba layers), not once for its one set of weights;
* the output projection over the published vocabulary.
"""

from __future__ import annotations

from typing import Dict


def _attention(cfg: Dict, s: int) -> int:
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["head_dim"]
    proj = 2 * s * d * (h * hd + 2 * kv * hd) + 2 * s * h * hd * d
    pairs = s * (s + 1) // 2
    return proj + 4 * hd * h * pairs


def _swiglu(s: int, d: int, f: int) -> int:
    return 3 * 2 * s * d * f


def _moe(cfg: Dict, s: int) -> int:
    d, e, k, f = cfg["d_model"], cfg["n_experts"], cfg["top_k"], \
        cfg["moe_d_ff"]
    return 2 * s * d * e + k * _swiglu(s, d, f)


def _mamba(cfg: Dict, s: int) -> int:
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    n, h, k = cfg["ssm_state"], cfg["ssm_heads"], cfg["ssm_conv"]
    p = di // h
    q = min(cfg["ssm_chunk"], s)
    nc = -(-s // q)
    pairs = q * (q + 1) // 2
    scan = (nc * pairs * 2 * n                  # C Bᵀ, one group
            + h * nc * pairs * 2 * p            # the decayed product with x
            + h * nc * 2 * q * n * p            # the chunk states
            + h * nc * 2 * q * n * p)           # C h across chunks
    return (2 * s * d * (2 * di + 2 * n + h) + 2 * s * k * (di + 2 * n)
            + scan + 2 * s * di * d)


def forward_flops(cfg: Dict, seq_len: int) -> int:
    """Forward products of one sequence of ``seq_len`` tokens."""
    s = seq_len
    family = cfg["family"]
    out = 2 * s * cfg["d_model"] * cfg["vocab"]
    if family == "hybrid":
        apps = cfg["n_layers"] // cfg["shared_attn_every"]
        return (out + cfg["n_layers"] * _mamba(cfg, s)
                + apps * (_attention(cfg, s)
                          + _swiglu(s, cfg["d_model"], cfg["d_ff"])))
    if family == "moe":
        return out + cfg["n_layers"] * (_attention(cfg, s) + _moe(cfg, s))
    if family == "dense":
        return out + cfg["n_layers"] * (
            _attention(cfg, s) + _swiglu(s, cfg["d_model"], cfg["d_ff"]))
    raise ValueError(f"no FLOP count for family {family!r}")


def train_step_flops(cfg: Dict, seq_len: int, sequences: int) -> int:
    """Model FLOPs of one train step over ``sequences`` sequences."""
    return 3 * sequences * forward_flops(cfg, seq_len)
