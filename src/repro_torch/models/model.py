"""Unified Model API and reduced configs.

Port of ``repro/models/model.py`` for every ``family``: "dense", "moe",
"hybrid", "ssm" (xLSTM), "audio" (whisper-style encoder-decoder) and
"vlm" (llama-vision-style).
``Model`` bundles the functions for one config:

    model.init(seed, device=None, trainable=False) -> params (an nn.Module)
    model.loss_fn(params, batch)               -> scalar loss   (train)
    model.forward(params, batch)               -> logits        (prefill)
    model.decode_init(batch, max_seq, device=None) -> decode state
    model.decode_fn(params, state, tokens, cache_len) -> (logits, state)
    model.prefill_fn(params, state, tokens)    -> (last_logits, state)
    model.decode_specs()                       -> the decode state's
                                                  logical axes

``batch`` holds ``tokens`` (B, S), and for "audio" ``enc_frames`` (B,
T_enc, d), for "vlm" ``image_embeds`` (B, n_img, d): the stubbed
frontends' embeddings.  ``prefill_fn`` is None for the hybrid and ssm
families, whose decode state is recurrent, and for the multimodal ones,
whose decode state is cross-attentive, as in the reference: servers fill
it token by token through ``decode_fn``.  Every family trains
(``loss_fn``, ``init(..., trainable=True)``: float32 parameters with
gradients); a multimodal batch also carries its frontend's embeddings
(``repro_torch.models.multimodal``).

``init`` and ``decode_init`` run on the CUDA card unless ``device`` says
otherwise, and raise without one (see ``repro_torch.device``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import multimodal, transformer, zamba


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    decode_init: Callable
    decode_fn: Callable
    prefill_fn: Optional[Callable] = None
    loss_fn: Optional[Callable] = None
    specs: Optional[Callable] = None
    decode_specs: Optional[Callable] = None

    def param_specs(self) -> Dict[str, tuple]:
        """Logical axes of every parameter, keyed by its name in
        ``named_parameters()`` (the reference's ``param_specs`` tree, one
        entry per layer of a stacked leaf, without the layer axis)."""
        return flat_tree(self.specs())

    def param_shapes(self) -> Dict[str, tuple]:
        """Every parameter's shape, keyed as :meth:`param_specs`, with
        nothing allocated."""
        from repro_torch.convert import param_shapes
        return param_shapes(self.cfg)


def flat_tree(tree, prefix: str = "") -> Dict[str, tuple]:
    """A spec tree (dicts and lists, tuples at the leaves) as a flat
    dict keyed by dotted paths, as ``named_parameters()`` names them."""
    if isinstance(tree, tuple):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, tuple] = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _init(init_fn: Callable, cfg: ModelConfig, seed: int, *,
          device: DeviceLike = None, trainable: bool = False) -> nn.Module:
    gen = torch.Generator(resolve_device(device)).manual_seed(seed)
    return init_fn(gen, cfg, trainable=trainable)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("dense", "moe"):
        t = transformer
        return Model(
            cfg=cfg,
            init=functools.partial(_init, t.lm_init, cfg),
            specs=lambda: t.lm_specs(cfg),
            loss_fn=lambda p, b: t.lm_loss(cfg, p, b),
            forward=lambda p, b: t.lm_forward(cfg, p, b["tokens"]),
            decode_init=lambda batch, max_seq, device=None: t.lm_decode_init(
                cfg, batch, max_seq, device=resolve_device(device)),
            decode_fn=lambda p, s, tok, ln: t.lm_decode_step(
                cfg, p, s, tok, ln),
            prefill_fn=lambda p, s, tok: t.lm_prefill(cfg, p, s, tok),
            decode_specs=lambda: t.lm_decode_specs(cfg),
        )
    if cfg.family == "hybrid":
        z = zamba
        return Model(
            cfg=cfg,
            init=functools.partial(_init, z.zamba_init, cfg),
            specs=lambda: z.zamba_specs(cfg),
            loss_fn=lambda p, b: z.zamba_loss(cfg, p, b),
            forward=lambda p, b: z.zamba_forward(cfg, p, b["tokens"]),
            decode_init=lambda batch, max_seq, device=None:
                z.zamba_decode_init(cfg, batch, max_seq,
                                    device=resolve_device(device)),
            decode_fn=lambda p, s, tok, ln: z.zamba_decode_step(
                cfg, p, s, tok, ln),
            decode_specs=lambda: z.zamba_decode_specs(cfg),
        )
    if cfg.family == "ssm":
        t = transformer
        return Model(
            cfg=cfg,
            init=functools.partial(_init, t.xlstm_init, cfg),
            specs=lambda: t.xlstm_specs(cfg),
            loss_fn=lambda p, b: t.xlstm_loss(cfg, p, b),
            forward=lambda p, b: t.xlstm_forward(cfg, p, b["tokens"]),
            decode_init=lambda batch, max_seq, device=None:
                t.xlstm_decode_init(cfg, batch, max_seq,
                                    device=resolve_device(device)),
            decode_fn=lambda p, s, tok, ln: t.xlstm_decode_step(
                cfg, p, s, tok, ln),
            decode_specs=lambda: t.xlstm_decode_specs(cfg),
        )
    if cfg.family == "audio":
        m = multimodal
        return Model(
            cfg=cfg,
            init=functools.partial(_init, m.encdec_init, cfg),
            specs=lambda: m.encdec_specs(cfg),
            loss_fn=lambda p, b: m.encdec_loss(cfg, p, b),
            forward=lambda p, b: m.encdec_forward(cfg, p, b["tokens"],
                                                  b["enc_frames"]),
            decode_init=lambda batch, max_seq, device=None:
                m.encdec_decode_init(cfg, batch, max_seq,
                                     device=resolve_device(device)),
            decode_fn=lambda p, s, tok, ln: m.encdec_decode_step(
                cfg, p, s, tok, ln),
            decode_specs=lambda: m.encdec_decode_specs(cfg),
        )
    if cfg.family == "vlm":
        m = multimodal
        return Model(
            cfg=cfg,
            init=functools.partial(_init, m.vlm_init, cfg),
            specs=lambda: m.vlm_specs(cfg),
            loss_fn=lambda p, b: m.vlm_loss(cfg, p, b),
            forward=lambda p, b: m.vlm_forward(cfg, p, b["tokens"],
                                               b["image_embeds"]),
            decode_init=lambda batch, max_seq, device=None:
                m.vlm_decode_init(cfg, batch, max_seq,
                                  device=resolve_device(device)),
            decode_fn=lambda p, s, tok, ln: m.vlm_decode_step(
                cfg, p, s, tok, ln),
            decode_specs=lambda: m.vlm_decode_specs(cfg),
        )
    raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# Reduced configs for CPU tests
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config: few layers, narrow widths, tiny vocab."""
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    red = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        attention_impl="naive",
        remat=False,
    )
    if cfg.is_moe:
        red.update(n_experts=4, top_k=2, moe_d_ff=32)
    if cfg.family in ("ssm",):
        red.update(slstm_every=2 if cfg.slstm_every else 0, n_layers=4)
    if cfg.family == "hybrid":
        red.update(shared_attn_every=2, n_layers=5, ssm_state=16,
                   ssm_heads=4)
    if cfg.family == "audio":
        red.update(encoder_layers=2, encoder_seq=16)
    if cfg.family == "vlm":
        red.update(cross_attn_every=2, n_layers=4, image_tokens=8)
    red.update(overrides)
    return dataclasses.replace(cfg, **red)
