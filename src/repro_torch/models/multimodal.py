"""Encoder-decoder (whisper-style, family "audio") and VLM
(llama-vision-style, family "vlm") backbones.

Port of ``repro/models/multimodal.py``.  The modality frontends are stubs,
as in the reference: ``enc_frames`` (B, T_enc, d) are precomputed frame
embeddings and ``image_embeds`` (B, n_img, d) precomputed patch
embeddings, both inputs.  The reference's stacked block trees become
``ModuleList``s of ``transformer.Block``:

- ``EncDecLM``: ``enc_blocks`` (self-attention with rope over the frames,
  non-causal), ``enc_ln``, then ``dec_blocks``, cross blocks whose
  causal self-attention is followed by cross-attention to the encoder's
  output;
- ``VisionLM``: ``n_layers // cross_attn_every`` super-blocks, each
  ``cross_attn_every - 1`` self blocks (``self_blocks``; self block ``j``
  of super-block ``i`` is row ``i * (k - 1) + j``) and then one cross
  block (``cross_blocks``) whose own self-attention is causal and whose
  cross-attention reads the image embeddings.

Every cross-attention adds ``tanh(xgate) x`` its output; ``xgate`` is a
float32 scalar initialised to 0, so at init the cross path adds nothing.

Decode keeps the reference's state layout: ``k``/``v`` (self blocks),
``ck``/``cv`` (the cross blocks' self-attention, VLM only) and ``xk``/
``xv``, the cross-attention's keys and values of the encoder output or
the image, which one decode step attends to in full, with no length mask
(``naive_attention``).  ``*_decode_init`` gives ``xk``/``xv`` as zeros and,
as in the reference, nothing writes them: a caller that has them (a test,
a frontend) writes them into the state.  The self-attention caches are
written in place.  Neither family has a batched prefill: servers fill the
state token by token through the decode step.

The loss functions are the reference's, and both families train (fp32
parameters with ``init(..., trainable=True)``).  Under autograd with
``cfg.remat`` every checkpoint region runs under the memory plan's policy
(``transformer.memory_plan(cfg, B * S)``, the reference's
``_remat_policy``): each encoder and decoder block of the encoder-decoder
(``scan_blocks``; the decoder's regions take the encoder's output as an
input, so its gradient sums over them), and each VLM super-block as one
region, as the reference's ``jax.checkpoint(super_body)``.  Serving (no
autograd) runs the blocks plainly.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.sharding import collectives as C
from repro_torch.models.transformer import (Block, Tree, _Checkpointed,
                                            _mlp_residual, _param,
                                            block_forward, block_init,
                                            block_specs,
                                            gated_cross_residual, lm_logits,
                                            memory_plan, padded_vocab,
                                            scan_blocks, softmax_xent)


def _blocks(gen: torch.Generator, cfg: ModelConfig, n: int, trainable: bool,
            *, cross: bool = False):
    return [block_init(gen, cfg, trainable=trainable, cross=cross)
            for _ in range(n)]


def _module_list(cfg: ModelConfig, trees, trainable: bool) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, t, trainable=trainable) for t in trees)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# decode: one block of one step
# ---------------------------------------------------------------------------

def _cross_decode(cfg: ModelConfig, p: Block, h: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """h + tanh(xgate) x the cross-attention of one token against the
    cached ``xk``/``xv`` (B, T, KV, hd), all T of them.  Under a mesh whose
    cross cache holds a block of the kv heads, this rank's heads
    (``attention.decode_heads``), ``wo``'s row block giving a partial
    output summed over ``model``."""
    dt = layers.dtype_of(cfg.dtype)
    b = h.shape[0]
    hd = cfg.head_dim
    q0, hq, _, kv = attn.decode_heads(cfg, xk.shape[2])
    hn = layers.rmsnorm(p.ln_x, h, cfg.norm_eps)
    q = layers.dense(C.fetch(p.xattn["wq"], 1, q0 * hd, hq * hd), hn,
                     dt).view(b, 1, hq, hd)
    xo = attn.naive_attention(q, attn._repeat_kv(xk, hq // kv),
                              attn._repeat_kv(xv, hq // kv), causal=False)
    xo = layers.dense(C.fetch(p.xattn["wo"], 0, q0 * hd, hq * hd),
                      xo.reshape(b, 1, hq * hd), dt)
    if hq < cfg.n_heads:
        xo = C.reduce_from(xo)
    return gated_cross_residual(p, h, xo)


def _decode_block(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  cache_len: torch.Tensor, xk=None, xv=None
                  ) -> torch.Tensor:
    """One block's decode step: self-attention over the cache (written in
    place at ``cache_len``), the cross-attention of a cross block, the
    MLP."""
    hn = layers.rmsnorm(p.ln1, x, cfg.norm_eps)
    ao, _, _ = attn.decode_attention(cfg, p.attn, hn, cache_k, cache_v,
                                     cache_len=cache_len)
    h = x + ao
    if p.cross:
        h = _cross_decode(cfg, p, h, xk, xv)
    return _mlp_residual(cfg, p, h)[0]


def _cross_kv(cfg: ModelConfig, n: int, batch: int, length: int, *, device
              ) -> Dict[str, torch.Tensor]:
    shape = (n, batch, length, cfg.n_kv_heads, cfg.head_dim)
    dt = layers.dtype_of(cfg.dtype)
    return {"xk": torch.zeros(shape, dtype=dt, device=device),
            "xv": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# Whisper-style encoder-decoder (family: audio)
# ---------------------------------------------------------------------------

def encdec_init(gen: torch.Generator, cfg: ModelConfig, *,
                trainable: bool = False) -> "EncDecLM":
    """Random init with the reference's distributions, on ``gen.device``."""
    dt = layers.weight_dtype(cfg, trainable)
    pv = padded_vocab(cfg)
    tree: Tree = {
        "embed": layers.embedding_init(gen, pv, cfg.d_model, dtype=dt),
        "enc_blocks": _blocks(gen, cfg, cfg.encoder_layers, trainable),
        "enc_ln": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "dec_blocks": _blocks(gen, cfg, cfg.n_layers, trainable, cross=True),
        "ln_f": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "unembed": layers.dense_init(gen, cfg.d_model, pv, dtype=dt),
    }
    return EncDecLM(cfg, tree, trainable=trainable)


def encdec_specs(cfg: ModelConfig) -> Tree:
    return {"embed": layers.embedding_specs(),
            "enc_blocks": [block_specs(cfg)
                           for _ in range(cfg.encoder_layers)],
            "enc_ln": layers.rmsnorm_specs(),
            "dec_blocks": [block_specs(cfg, cross=True)
                           for _ in range(cfg.n_layers)],
            "ln_f": layers.rmsnorm_specs(),
            "unembed": layers.dense_specs("embed", "vocab")}


class EncDecLM(nn.Module):
    """Parameters of the encoder-decoder; ``forward(tokens, enc_frames)``
    gives all logits.  Served, it holds its matmul weights in the compute
    dtype, frozen; ``trainable=True`` holds every parameter in float32."""

    def __init__(self, cfg: ModelConfig, tree: Tree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"], trainable)
        self.enc_blocks = _module_list(cfg, tree["enc_blocks"], trainable)
        self.enc_ln = _param(tree["enc_ln"], trainable)
        self.dec_blocks = _module_list(cfg, tree["dec_blocks"], trainable)
        self.ln_f = _param(tree["ln_f"], trainable)
        self.unembed = _param(tree["unembed"], trainable)

    def forward(self, tokens: torch.Tensor, enc_frames: torch.Tensor
                ) -> torch.Tensor:
        return encdec_forward(self.cfg, self, tokens, enc_frames)


def encdec_encode(cfg: ModelConfig, params: EncDecLM,
                  enc_frames: torch.Tensor) -> torch.Tensor:
    """enc_frames: (B, T_enc, d) -> the normed encoder output (B, T_enc, d)
    in the compute dtype: non-causal self-attention with rope."""
    b, t, _ = enc_frames.shape
    x = enc_frames.to(layers.dtype_of(cfg.dtype))
    x, _ = scan_blocks(cfg, params.enc_blocks, x,
                       _positions(b, t, x.device), causal=False)
    return layers.rmsnorm(params.enc_ln, x, cfg.norm_eps)


def encdec_forward(cfg: ModelConfig, params: EncDecLM, tokens: torch.Tensor,
                   enc_frames: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S), enc_frames: (B, T_enc, d) -> logits (B, S,
    padded_vocab)."""
    enc = encdec_encode(cfg, params, enc_frames)
    b, s = tokens.shape
    x = layers.embed(params.embed, tokens, layers.dtype_of(cfg.dtype))
    x, _ = scan_blocks(cfg, params.dec_blocks, x,
                       _positions(b, s, tokens.device), kv_x=enc,
                       causal=True)
    return lm_logits(cfg, params, x)


def encdec_loss(cfg: ModelConfig, params: EncDecLM, batch) -> torch.Tensor:
    """Next-token cross-entropy (the reference's ``encdec_loss``)."""
    return softmax_xent(cfg, encdec_forward(cfg, params, batch["tokens"],
                                            batch["enc_frames"]),
                        batch["targets"])


def encdec_decode_init(cfg: ModelConfig, batch: int, max_seq: int, *,
                       device) -> Dict[str, torch.Tensor]:
    """``k``/``v`` (n_layers, B, max_seq, KV, hd) and ``xk``/``xv``
    (n_layers, B, encoder_seq, KV, hd), all zeros."""
    dt = layers.dtype_of(cfg.dtype)
    cache = attn.init_kv_cache(cfg, batch, max_seq, cfg.n_layers, dt,
                               device=device)
    cache.update(_cross_kv(cfg, cfg.n_layers, batch, cfg.encoder_seq,
                           device=device))
    return cache


def encdec_decode_specs(cfg: ModelConfig) -> Tree:
    """The decode state's logical axes (the reference's)."""
    s = attn.kv_cache_specs()
    s["xk"] = (None, "batch", None, "kv_heads", None)
    s["xv"] = (None, "batch", None, "kv_heads", None)
    return s


def encdec_decode_step(cfg: ModelConfig, params: EncDecLM,
                       cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                       cache_len: torch.Tensor):
    """tokens: (B,) new ids; cache_len: (B,) current lengths.

    Returns ``(logits (B, padded_vocab), cache)``; the cache is updated in
    place.
    """
    x = layers.embed(params.embed, tokens[:, None],
                     layers.dtype_of(cfg.dtype))
    for i, p in enumerate(params.dec_blocks):
        x = _decode_block(cfg, p, x, cache["k"][i], cache["v"][i], cache_len,
                          cache["xk"][i], cache["xv"][i])
    return lm_logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# VLM: decoder with cross-attention super-blocks (family: vlm)
# ---------------------------------------------------------------------------

def vlm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, per): ``n_super`` super-blocks of ``per`` self blocks and
    one cross block (llama-3.2-vision-11b: 8 of 4 + 1)."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def vlm_init(gen: torch.Generator, cfg: ModelConfig, *,
             trainable: bool = False) -> "VisionLM":
    """Random init with the reference's distributions, on ``gen.device``."""
    dt = layers.weight_dtype(cfg, trainable)
    pv = padded_vocab(cfg)
    n_super, per = vlm_layout(cfg)
    tree: Tree = {
        "embed": layers.embedding_init(gen, pv, cfg.d_model, dtype=dt),
        "self_blocks": _blocks(gen, cfg, n_super * per, trainable),
        "cross_blocks": _blocks(gen, cfg, n_super, trainable, cross=True),
        "ln_f": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "unembed": layers.dense_init(gen, cfg.d_model, pv, dtype=dt),
    }
    return VisionLM(cfg, tree, trainable=trainable)


def vlm_specs(cfg: ModelConfig) -> Tree:
    n_super, per = vlm_layout(cfg)
    return {"embed": layers.embedding_specs(),
            "self_blocks": [block_specs(cfg) for _ in range(n_super * per)],
            "cross_blocks": [block_specs(cfg, cross=True)
                             for _ in range(n_super)],
            "ln_f": layers.rmsnorm_specs(),
            "unembed": layers.dense_specs("embed", "vocab")}


class VisionLM(nn.Module):
    """Parameters of the VLM; ``forward(tokens, image_embeds)`` gives all
    logits.  Served, it holds its matmul weights in the compute dtype,
    frozen; ``trainable=True`` holds every parameter in float32."""

    def __init__(self, cfg: ModelConfig, tree: Tree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"], trainable)
        self.self_blocks = _module_list(cfg, tree["self_blocks"], trainable)
        self.cross_blocks = _module_list(cfg, tree["cross_blocks"],
                                         trainable)
        self.ln_f = _param(tree["ln_f"], trainable)
        self.unembed = _param(tree["unembed"], trainable)

    def forward(self, tokens: torch.Tensor, image_embeds: torch.Tensor
                ) -> torch.Tensor:
        return vlm_forward(self.cfg, self, tokens, image_embeds)


def vlm_forward(cfg: ModelConfig, params: VisionLM, tokens: torch.Tensor,
                image_embeds: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S), image_embeds: (B, n_img, d) -> logits (B, S,
    padded_vocab).  Under autograd with ``cfg.remat`` each super-block is
    one checkpoint region under the memory plan's policy, as the
    reference's ``jax.checkpoint(super_body)``."""
    b, s = tokens.shape
    n_super, per = vlm_layout(cfg)
    dt = layers.dtype_of(cfg.dtype)
    x = layers.embed(params.embed, tokens, dt)
    positions = _positions(b, s, tokens.device)
    img = image_embeds.to(dt)
    run = _Checkpointed(cfg)
    policy = memory_plan(cfg, b * s).offload_policy if run.on else None
    for i in range(n_super):
        body = functools.partial(
            _super_block, cfg, params.self_blocks[i * per:(i + 1) * per],
            params.cross_blocks[i])
        x = run(policy, body, x, positions, img)
    return lm_logits(cfg, params, x)


def _super_block(cfg: ModelConfig, self_blocks, cross: Block,
                 x: torch.Tensor, positions: torch.Tensor,
                 img: torch.Tensor) -> torch.Tensor:
    """The reference's ``super_body``: ``self_blocks`` in turn, then the
    cross block attending to ``img``.  Its auxiliary loss, which the
    reference's ``vlm_loss`` drops (and which is 0 for these dense
    blocks), is not formed.  It opens no region of its own:
    ``core/remat.py`` does not nest them."""
    for p in self_blocks:
        x = block_forward(cfg, p, x, positions)
    return block_forward(cfg, cross, x, positions, img)


def vlm_loss(cfg: ModelConfig, params: VisionLM, batch) -> torch.Tensor:
    """Next-token cross-entropy (the reference's ``vlm_loss``)."""
    return softmax_xent(cfg, vlm_forward(cfg, params, batch["tokens"],
                                         batch["image_embeds"]),
                        batch["targets"])


def vlm_decode_init(cfg: ModelConfig, batch: int, max_seq: int, *, device
                    ) -> Dict[str, torch.Tensor]:
    """``k``/``v`` for the self blocks, ``ck``/``cv`` for the cross
    blocks' self-attention (each (n, B, max_seq, KV, hd)) and ``xk``/``xv``
    (n_super, B, image_tokens, KV, hd), all zeros."""
    n_super, per = vlm_layout(cfg)
    dt = layers.dtype_of(cfg.dtype)
    cache = attn.init_kv_cache(cfg, batch, max_seq, n_super * per, dt,
                               device=device)
    cross = attn.init_kv_cache(cfg, batch, max_seq, n_super, dt,
                               device=device)
    cache.update(ck=cross["k"], cv=cross["v"])
    cache.update(_cross_kv(cfg, n_super, batch, cfg.image_tokens,
                           device=device))
    return cache


def vlm_decode_specs(cfg: ModelConfig) -> Tree:
    """The decode state's logical axes (the reference's)."""
    base = (None, "batch", "kv_seq", "kv_heads", None)
    return {**{n: base for n in ("k", "v", "ck", "cv")},
            "xk": (None, "batch", None, "kv_heads", None),
            "xv": (None, "batch", None, "kv_heads", None)}


def vlm_decode_step(cfg: ModelConfig, params: VisionLM,
                    cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                    cache_len: torch.Tensor):
    """tokens: (B,) new ids; cache_len: (B,) current lengths.

    Returns ``(logits (B, padded_vocab), cache)``; the cache is updated in
    place.
    """
    n_super, per = vlm_layout(cfg)
    x = layers.embed(params.embed, tokens[:, None],
                     layers.dtype_of(cfg.dtype))
    for i in range(n_super):
        for r in range(i * per, (i + 1) * per):
            x = _decode_block(cfg, params.self_blocks[r], x, cache["k"][r],
                              cache["v"][r], cache_len)
        x = _decode_block(cfg, params.cross_blocks[i], x, cache["ck"][i],
                          cache["cv"][i], cache_len, cache["xk"][i],
                          cache["xv"][i])
    return lm_logits(cfg, params, x)[:, 0], cache
