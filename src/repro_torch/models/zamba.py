"""Zamba2-style hybrid (family: hybrid): a mamba2 backbone with ONE shared
attention block applied every ``shared_attn_every`` layers.

Port of ``repro/models/zamba.py``.  The shared block is one
``transformer.Block`` instance that every group calls: one parameter set
at many execution sites, NNTrainer's tensor-sharing mode E.  The layout
follows the reference: ``n_groups`` groups of ``shared_attn_every`` mamba
layers, each followed by the shared block, then a tail of the remaining
mamba layers.  The decode state holds each mamba layer's SSM state and one
KV cache per application of the shared block; it is updated in place.
The family has no batched prefill (its state is recurrent): servers fill
the state token by token through ``zamba_decode_step``.

Training (``zamba_loss``) follows the reference's checkpoint structure
with ``cfg.remat`` under autograd, flattened: each mamba layer is
checkpointed with nothing saved (rebuilt from its input in the backward),
and each application of the shared block under the memory plan's policy
(``transformer.memory_plan``).  The reference nests the mamba layers'
checkpoints inside one per group; ``core/remat.py`` does not nest regions,
so a group here holds k - 1 more mamba-layer inputs for its backward (the
same function; 29 MB each at one sequence of 4096 in bf16).  The shared
block's gradient is the sum over its applications, as autograd through
one parameter set gives it.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import remat
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import (Block, Tree, _Checkpointed,
                                            _mlp_residual, _param,
                                            _param_dict, block_forward,
                                            block_init, block_specs,
                                            lm_logits, memory_plan,
                                            padded_vocab, softmax_xent)


def layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, tail): ``n_groups`` full groups of ``shared_attn_every``
    mamba layers + one shared-block application; the remaining mamba
    layers form the tail."""
    k = cfg.shared_attn_every
    return cfg.n_layers // k, cfg.n_layers % k


class MambaLayer(nn.Module):
    """Pre-norm mamba2 layer: x + ssm(norm(x))."""

    def __init__(self, tree: Tree, *, trainable: bool = False):
        super().__init__()
        self.ln = _param(tree["ln"], trainable)
        self.ssm = _param_dict(tree["ssm"], trainable)


def _mamba_init(gen: torch.Generator, cfg: ModelConfig, trainable: bool
                ) -> Tree:
    return {"ln": layers.rmsnorm_init(cfg.d_model, device=gen.device),
            "ssm": ssm.ssm_init(gen, cfg, trainable=trainable)}


def zamba_init(gen: torch.Generator, cfg: ModelConfig, *,
               trainable: bool = False) -> "ZambaLM":
    """Random init with the reference's distributions, on ``gen.device``."""
    dt = layers.weight_dtype(cfg, trainable)
    pv = padded_vocab(cfg)
    n_groups, tail = layout(cfg)
    tree: Tree = {
        "embed": layers.embedding_init(gen, pv, cfg.d_model, dtype=dt),
        "mblocks": [_mamba_init(gen, cfg, trainable)
                    for _ in range(n_groups * cfg.shared_attn_every)],
        "shared": block_init(gen, cfg, trainable=trainable),
        "tail": [_mamba_init(gen, cfg, trainable) for _ in range(tail)],
        "ln_f": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "unembed": layers.dense_init(gen, cfg.d_model, pv, dtype=dt),
    }
    return ZambaLM(cfg, tree, trainable=trainable)


def zamba_specs(cfg: ModelConfig) -> Tree:
    n_groups, tail = layout(cfg)

    def mamba():
        return {"ln": layers.rmsnorm_specs(), "ssm": ssm.ssm_specs(cfg)}

    return {"embed": layers.embedding_specs(),
            "mblocks": [mamba() for _ in
                        range(n_groups * cfg.shared_attn_every)],
            "shared": block_specs(cfg),
            "tail": [mamba() for _ in range(tail)],
            "ln_f": layers.rmsnorm_specs(),
            "unembed": layers.dense_specs("embed", "vocab")}


class ZambaLM(nn.Module):
    """Parameters of the hybrid LM; ``forward(tokens)`` gives all logits.
    Served, it holds its matmul weights in the compute dtype, frozen;
    ``trainable=True`` holds every parameter in float32 with gradients."""

    def __init__(self, cfg: ModelConfig, tree: Tree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"], trainable)
        mblocks: List[Tree] = tree["mblocks"]
        self.mblocks = nn.ModuleList(MambaLayer(t, trainable=trainable)
                                     for t in mblocks)
        self.shared = Block(cfg, tree["shared"], trainable=trainable)
        self.tail = nn.ModuleList(MambaLayer(t, trainable=trainable)
                                  for t in tree["tail"])
        self.ln_f = _param(tree["ln_f"], trainable)
        self.unembed = _param(tree["unembed"], trainable)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return zamba_forward(self.cfg, self, tokens)


def _mamba(cfg: ModelConfig, p: MambaLayer, x: torch.Tensor) -> torch.Tensor:
    return x + ssm.ssm_forward(cfg, p.ssm,
                               layers.rmsnorm(p.ln, x, cfg.norm_eps))


def zamba_forward(cfg: ModelConfig, params: ZambaLM, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab)."""
    b, s = tokens.shape
    n_groups, _ = layout(cfg)
    k = cfg.shared_attn_every
    x = layers.embed(params.embed, tokens, layers.dtype_of(cfg.dtype))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    run = _Checkpointed(cfg)
    policy = memory_plan(cfg, b * s).offload_policy if run.on else None
    full = remat.FULL_RECOMPUTE

    def shared(x, positions):
        # the shared block: the same parameters at every application
        return block_forward(cfg, params.shared, x, positions)

    for g in range(n_groups):
        for p in params.mblocks[g * k:(g + 1) * k]:
            x = run(full, functools.partial(_mamba, cfg, p), x)
        x = run(policy, shared, x, positions)
    for p in params.tail:
        x = run(full, functools.partial(_mamba, cfg, p), x)
    return lm_logits(cfg, params, x)


def zamba_loss(cfg: ModelConfig, params: ZambaLM, batch) -> torch.Tensor:
    """Next-token cross-entropy (the reference's ``zamba_loss``)."""
    return softmax_xent(cfg, zamba_forward(cfg, params, batch["tokens"]),
                        batch["targets"])


# ---- decode ----------------------------------------------------------------

def zamba_decode_init(cfg: ModelConfig, batch: int, max_seq: int, *, device
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    n_groups, tail = layout(cfg)
    st = {
        "ssm": ssm.init_ssm_state(cfg, batch, n_groups * cfg.shared_attn_every,
                                  device=device),
        "attn": attn.init_kv_cache(cfg, batch, max_seq, n_groups,
                                   layers.dtype_of(cfg.dtype), device=device),
    }
    if tail:
        st["tail"] = ssm.init_ssm_state(cfg, batch, tail, device=device)
    return st


def zamba_decode_specs(cfg: ModelConfig) -> Tree:
    """The decode state's logical axes (the reference's)."""
    _, tail = layout(cfg)
    s = {"ssm": ssm.ssm_state_specs(), "attn": attn.kv_cache_specs()}
    if tail:
        s["tail"] = ssm.ssm_state_specs()
    return s


def _mamba_step(cfg: ModelConfig, p: MambaLayer, x: torch.Tensor,
                state: Dict[str, torch.Tensor], i: int) -> torch.Tensor:
    """One mamba layer's decode step; writes its state ``i`` in place."""
    y, new_h, new_conv = ssm.ssm_decode_step(
        cfg, p.ssm, layers.rmsnorm(p.ln, x, cfg.norm_eps), state["h"][i],
        state["conv"][i])
    state["h"][i] = new_h
    state["conv"][i] = new_conv
    return x + y


def zamba_decode_step(cfg: ModelConfig, params: ZambaLM, state,
                      tokens: torch.Tensor, cache_len: torch.Tensor):
    """tokens: (B,) new ids; cache_len: (B,) current lengths.

    Returns ``(logits (B, padded_vocab), state)``; the state is updated in
    place.
    """
    n_groups, _ = layout(cfg)
    k = cfg.shared_attn_every
    x = layers.embed(params.embed, tokens[:, None],
                     layers.dtype_of(cfg.dtype))
    sh = params.shared
    for g in range(n_groups):
        for j in range(k):
            x = _mamba_step(cfg, params.mblocks[g * k + j], x, state["ssm"],
                            g * k + j)
        hn = layers.rmsnorm(sh.ln1, x, cfg.norm_eps)
        ao, _, _ = attn.decode_attention(
            cfg, sh.attn, hn, state["attn"]["k"][g], state["attn"]["v"][g],
            cache_len=cache_len)
        x = _mlp_residual(cfg, sh, x + ao)[0]
    for i, p in enumerate(params.tail):
        x = _mamba_step(cfg, p, x, state["tail"], i)
    return lm_logits(cfg, params, x)[:, 0], state
