"""Dense decoder-only LM (llama3.2 / phi4 / minitron / granite family).

Port of the dense part of ``repro/models/transformer.py``.  Parameters
are built as plain nested dicts (``lm_init``, or ``convert.py`` from the
reference's tree) and held by the ``TransformerLM`` module: the
reference's stacked ``blocks`` axis becomes a ``ModuleList`` of ``Block``s.
Matmul weights and the embedding table are held in the compute dtype;
norm scales stay float32.  The parameters are frozen: this slice serves,
and training comes with a later slice (with the reference's planner-driven
remat policy, which matters only under autodiff).

The functions keep the reference's ``(cfg, params, ...)`` signatures.
The KV cache is updated in place.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers

VOCAB_PAD = 256

Tree = Dict[str, object]


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(tree: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Decoder block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    dt = layers.dtype_of(cfg.dtype)
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "attn": attn.attention_init(gen, cfg, dtype=dt),
        "ln2": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "mlp": layers.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dt),
    }


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then + swiglu(norm(.))."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _frozen(tree["ln1"])
        self.attn = _frozen_dict(tree["attn"])
        self.ln2 = _frozen(tree["ln2"])
        self.mlp = _frozen_dict(tree["mlp"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return block_forward(self.cfg, self, x, positions)


def block_forward(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    h = x + attn.attention_forward(
        cfg, p.attn, layers.rmsnorm(p.ln1, x, cfg.norm_eps),
        positions=positions)
    return _mlp_residual(cfg, p, h)


def _mlp_residual(cfg: ModelConfig, p: Block, h: torch.Tensor
                  ) -> torch.Tensor:
    hn = layers.rmsnorm(p.ln2, h, cfg.norm_eps)
    return h + layers.swiglu(p.mlp, hn, layers.dtype_of(cfg.dtype))


# ---------------------------------------------------------------------------
# Decoder-only LM
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: ModelConfig) -> "TransformerLM":
    """Random init with the reference's distributions, on ``gen.device``."""
    dt = layers.dtype_of(cfg.dtype)
    pv = padded_vocab(cfg)
    tree: Tree = {
        "embed": layers.embedding_init(gen, pv, cfg.d_model, dtype=dt),
        "blocks": [block_init(gen, cfg) for _ in range(cfg.n_layers)],
        "ln_f": layers.rmsnorm_init(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = layers.dense_init(gen, cfg.d_model, pv, dtype=dt)
    return TransformerLM(cfg, tree)


class TransformerLM(nn.Module):
    """Parameters of the dense LM; ``forward(tokens)`` gives all logits."""

    def __init__(self, cfg: ModelConfig, tree: Tree):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        blocks: List[Tree] = tree["blocks"]
        self.blocks = nn.ModuleList(Block(cfg, b) for b in blocks)
        self.ln_f = _frozen(tree["ln_f"])
        self.unembed = _frozen(tree["unembed"]) if "unembed" in tree else None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_forward(self.cfg, self, tokens)


def lm_logits(cfg: ModelConfig, params: TransformerLM,
              x: torch.Tensor) -> torch.Tensor:
    dt = layers.dtype_of(cfg.dtype)
    x = layers.rmsnorm(params.ln_f, x, cfg.norm_eps)
    if params.unembed is None:
        return layers.unembed(params.embed, x, dt)
    return layers.dense(params.unembed, x, dt)


def lm_forward(cfg: ModelConfig, params: TransformerLM,
               tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab)."""
    b, s = tokens.shape
    x = layers.embed(params.embed, tokens, layers.dtype_of(cfg.dtype))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    for blk in params.blocks:
        x = block_forward(cfg, blk, x, positions)
    return lm_logits(cfg, params, x)


# ---- decode ----------------------------------------------------------------

def lm_decode_init(cfg: ModelConfig, batch: int, max_seq: int, *, device
                   ) -> Dict[str, torch.Tensor]:
    return attn.init_kv_cache(cfg, batch, max_seq, cfg.n_layers,
                              layers.dtype_of(cfg.dtype), device=device)


def lm_decode_step(cfg: ModelConfig, params: TransformerLM,
                   cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   cache_len: torch.Tensor):
    """tokens: (B,) new ids; cache_len: (B,) current lengths.

    Returns ``(logits (B, padded_vocab), cache)``; the cache is updated in
    place.
    """
    x = layers.embed(params.embed, tokens[:, None],
                     layers.dtype_of(cfg.dtype))
    for i, p in enumerate(params.blocks):
        hn = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
        ao, _, _ = attn.decode_attention(cfg, p.attn, hn, cache["k"][i],
                                         cache["v"][i], cache_len=cache_len)
        x = _mlp_residual(cfg, p, x + ao)
    return lm_logits(cfg, params, x)[:, 0], cache


def lm_prefill(cfg: ModelConfig, params: TransformerLM,
               cache: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """Batched prefill: one full-sequence causal forward that fills the
    (empty) KV cache, replacing S sequential ``lm_decode_step`` calls.

    tokens: (B, S).  Returns ``(last_logits (B, padded_vocab), cache)``,
    the cache holding all S positions, ready for decode at cache_len = S.
    """
    x = layers.embed(params.embed, tokens, layers.dtype_of(cfg.dtype))
    for i, p in enumerate(params.blocks):
        hn = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
        ao, _, _ = attn.prefill_attention(cfg, p.attn, hn, cache["k"][i],
                                          cache["v"][i])
        x = _mlp_residual(cfg, p, x + ao)
    return lm_logits(cfg, params, x[:, -1:])[:, 0], cache
