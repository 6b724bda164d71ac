"""The granite-moe family in plain float32 PyTorch: pre-norm blocks of
rotary grouped-query attention and a mixture-of-experts SwiGLU FFN,
embeddings tied to the output projection.

The MoE layer routes each token to its top-k experts by a float32
softmax router, the chosen weights renormalised to sum to 1.  Tokens are
grouped (one group a sequence, or ``moe_group_tokens`` of a longer one);
in each group an expert takes the first ``capacity`` tokens that chose
it, in token order, with ``capacity = ceil(group * k / experts *
capacity_factor)``, and a token it has no room for gets nothing from it.
The load-balancing term, ``experts * sum_e(share of tokens choosing e *
mean router probability of e)`` over the micro-batch, is added to the
loss times ``aux_loss_weight`` for every layer (Switch Transformer,
arXiv:2101.03961).  Each expert's tokens are gathered and its FFN run on
them alone: the same function as one-hot dispatch, without its products.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from chipbench.reference import common
from chipbench.reference.common import (Matmul, Params, ckpt, padded_vocab,
                                        rmsnorm)

Layout = List[Tuple[str, Tuple[int, ...], Tuple]]


def layout(cfg: Dict) -> Layout:
    """Every parameter: (name, shape, how it is drawn)."""
    d, pv = cfg["d_model"], padded_vocab(cfg)
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    e, f = cfg["n_experts"], cfg["moe_d_ff"]
    s = 1 / math.sqrt(d)
    out: Layout = [("embed", (pv, d), ("normal", 0.02)),
                   ("ln_f", (d,), ("ones",))]
    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}."
        out += [(pre + "attn.wk", (d, kv * hd), ("normal", s)),
                (pre + "attn.wo", (h * hd, d),
                 ("normal", 1 / math.sqrt(h * hd))),
                (pre + "attn.wq", (d, h * hd), ("normal", s)),
                (pre + "attn.wv", (d, kv * hd), ("normal", s)),
                (pre + "ln1", (d,), ("ones",)),
                (pre + "ln2", (d,), ("ones",)),
                (pre + "moe.down", (e, f, d), ("normal", 1 / math.sqrt(f))),
                (pre + "moe.gate", (e, d, f), ("normal", s)),
                (pre + "moe.router", (d, e), ("normal", s)),
                (pre + "moe.up", (e, d, f), ("normal", s))]
    return sorted(out)


def moe(cfg: Dict, p: Params, pre: str, x: torch.Tensor, mm: Matmul
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (the experts' weighted sum (B, S, d), the
    load-balancing term)."""
    b0, s0, d = x.shape
    group = min(cfg["moe_group_tokens"], s0)
    x = x.reshape(b0 * s0 // group, group, d)
    g, s, _ = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    capacity = max(int(math.ceil(s * k / e * cfg["capacity_factor"])), 1)
    probs = torch.softmax(x @ p[pre + "moe.router"], dim=-1)   # (G,S,E)
    topi = torch.topk(probs, k, dim=-1).indices
    mask = torch.zeros_like(probs).scatter_(-1, topi, 1.0)
    weights = probs * mask
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    aux = e * torch.sum(mask.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
    slot = torch.cumsum(mask, dim=1) * mask - 1.0
    taken = (slot < capacity) & (mask > 0)                       # (G,S,E)
    flat = x.reshape(g * s, d)
    out = torch.zeros_like(flat)
    taken, weights = taken.reshape(g * s, e), weights.reshape(g * s, e)
    for j in range(e):
        rows = torch.nonzero(taken[:, j]).squeeze(1)
        if rows.numel() == 0:
            continue
        y = common.swiglu(p[pre + "moe.gate"][j], p[pre + "moe.up"][j],
                          p[pre + "moe.down"][j], flat[rows], mm)
        out = out.index_add(0, rows, y * weights[rows, j, None])
    return out.reshape(b0, s0, d), aux


def block(cfg: Dict, p: Params, pre: str, x: torch.Tensor, mm: Matmul
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    eps = cfg["norm_eps"]
    h = x + common.attention(cfg, p, pre + "attn.", rmsnorm(p[pre + "ln1"],
                                                            x, eps), mm)
    mo, aux = moe(cfg, p, pre, rmsnorm(p[pre + "ln2"], h, eps), mm)
    return h + mo, aux


def loss(cfg: Dict, p: Params, tokens: torch.Tensor, targets: torch.Tensor,
         mm: Matmul) -> torch.Tensor:
    """Mean next-token cross-entropy of one micro-batch plus
    ``aux_loss_weight`` times the layers' load-balancing terms."""
    x = F.embedding(tokens.long(), p["embed"])
    aux = torch.zeros((), device=x.device)
    for i in range(cfg["n_layers"]):
        x, a = ckpt(lambda x, pre=f"blocks.{i}.": block(cfg, p, pre, x, mm),
                    x)
        aux = aux + a
    return common.output_xent(rmsnorm(p["ln_f"], x, cfg["norm_eps"]),
                              p["embed"].t(), targets, cfg["vocab"], mm) \
        + cfg["aux_loss_weight"] * aux
