"""Unified Model API and reduced configs.

Port of ``repro/models/model.py`` for ``family == "dense"``.  ``Model``
bundles the functions for one config:

    model.init(seed, device=None)              -> params (TransformerLM)
    model.forward(params, batch)               -> logits        (prefill)
    model.decode_init(batch, max_seq, device=None) -> KV cache
    model.decode_fn(params, cache, tokens, cache_len) -> (logits, cache)
    model.prefill_fn(params, cache, tokens)    -> (last_logits, cache)

``init`` and ``decode_init`` run on the CUDA card unless ``device`` says
otherwise, and raise without one (see ``repro_torch.device``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    decode_init: Callable
    decode_fn: Callable
    prefill_fn: Callable


def _init(cfg: ModelConfig, seed: int, *, device: DeviceLike = None
          ) -> transformer.TransformerLM:
    gen = torch.Generator(resolve_device(device)).manual_seed(seed)
    return transformer.lm_init(gen, cfg)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port covers the "
            "dense LM; moe, ssm, hybrid, audio and vlm come with slice 3 "
            "of the port (ROADMAP queue A, item 10)")
    t = transformer
    return Model(
        cfg=cfg,
        init=functools.partial(_init, cfg),
        forward=lambda p, b: t.lm_forward(cfg, p, b["tokens"]),
        decode_init=lambda batch, max_seq, device=None: t.lm_decode_init(
            cfg, batch, max_seq, device=resolve_device(device)),
        decode_fn=lambda p, s, tok, ln: t.lm_decode_step(cfg, p, s, tok, ln),
        prefill_fn=lambda p, s, tok: t.lm_prefill(cfg, p, s, tok),
    )


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
