"""Decoder-only LM, dense (llama3.2 / phi4 / minitron / granite family) or
with MoE FFNs (granite-moe / qwen3-moe family), and the xLSTM stack
(family "ssm").

Port of the LM and xLSTM parts of ``repro/models/transformer.py``.
Parameters are built as plain nested dicts (``lm_init``, or ``convert.py``
from the reference's tree) and held by the ``TransformerLM`` module: the
reference's stacked ``blocks`` axis becomes a ``ModuleList`` of ``Block``s.
A served LM holds its matmul weights and embedding table in the compute
dtype and its parameters frozen; a trainable one (``trainable=True``)
holds every parameter in float32 (``param_dtype``) with gradients, and
each matmul casts to the compute dtype at use, as the reference does.
Norm scales are float32 either way.

Under autograd with ``cfg.remat`` each block runs checkpointed under the
memory plan's policy (``compile_plan(cfg, batch_tokens=B * S)``, the
reference's ``_remat_policy``): ``repro_torch.core.remat`` keeps,
offloads or recomputes each tagged intermediate as the plan decides.  An
xLSTM block is checkpointed with nothing saved (``remat.FULL_RECOMPUTE``),
as the reference's ``jax.checkpoint`` of its ``mbody`` and ``sbody``.  The
LM loss (``lm_loss``) carries the MoE auxiliary loss through the stack as
the reference's ``_scan_blocks`` does; serving discards it.

The functions keep the reference's ``(cfg, params, ...)`` signatures.
The KV cache and the xLSTM decode state are updated in place.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import remat
from repro_torch.core.plan import CompiledMemoryPlan, compile_plan
from repro_torch.core.remat_policy import tag
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, xlstm
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R

VOCAB_PAD = 256

Tree = Dict[str, object]


def padded_vocab(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _param_dict(tree: Dict[str, torch.Tensor], trainable: bool
                ) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v, trainable)
                             for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Decoder block
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, *,
               trainable: bool = False, cross: bool = False) -> Tree:
    """An MoE config's block holds ``moe`` (router and experts), any other
    ``mlp``, as the reference's does; a ``cross`` block also holds its
    cross-attention: ``ln_x``, ``xattn`` and the float32 gate ``xgate``,
    0 at init (tanh(0) = 0: the cross path adds nothing until trained)."""
    dt = layers.weight_dtype(cfg, trainable)
    tree = {
        "ln1": layers.rmsnorm_init(cfg.d_model, device=gen.device),
        "attn": attn.attention_init(gen, cfg, dtype=dt),
        "ln2": layers.rmsnorm_init(cfg.d_model, device=gen.device),
    }
    if cfg.is_moe:
        tree["moe"] = moe.moe_init(gen, cfg, dtype=dt)
    else:
        tree["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff,
                                         dtype=dt)
    if cross:
        tree["ln_x"] = layers.rmsnorm_init(cfg.d_model, device=gen.device)
        tree["xattn"] = attn.attention_init(gen, cfg, dtype=dt)
        tree["xgate"] = torch.zeros((), dtype=torch.float32,
                                    device=gen.device)
    return tree


def block_specs(cfg: ModelConfig, *, cross: bool = False) -> Tree:
    """Logical axes of one block's parameters, as ``block_init`` lays
    them out."""
    s: Tree = {"ln1": layers.rmsnorm_specs(), "attn": attn.attention_specs(),
               "ln2": layers.rmsnorm_specs()}
    if cfg.is_moe:
        s["moe"] = moe.moe_specs()
    else:
        s["mlp"] = layers.swiglu_specs()
    if cross:
        s["ln_x"] = layers.rmsnorm_specs()
        s["xattn"] = attn.attention_specs()
        s["xgate"] = ()
    return s


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then + swiglu(norm(.)) or, for an
    MoE config, + moe(norm(.)).  A cross block (its tree holds ``xattn``)
    adds tanh(xgate) x cross-attention between the two."""

    def __init__(self, cfg: ModelConfig, tree: Tree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param(tree["ln1"], trainable)
        self.attn = _param_dict(tree["attn"], trainable)
        self.ln2 = _param(tree["ln2"], trainable)
        if cfg.is_moe:
            self.moe = _param_dict(tree["moe"], trainable)
        else:
            self.mlp = _param_dict(tree["mlp"], trainable)
        self.cross = "xattn" in tree
        if self.cross:
            self.ln_x = _param(tree["ln_x"], trainable)
            self.xattn = _param_dict(tree["xattn"], trainable)
            self.xgate = _param(tree["xgate"], trainable)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        return block_forward(self.cfg, self, x, positions)


def block_forward_aux(cfg: ModelConfig, p: Block, x: torch.Tensor,
                      positions: torch.Tensor,
                      kv_x: Optional[torch.Tensor] = None, *,
                      causal: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``block_forward``: (y, the MoE auxiliary loss, 0 for
    a dense block), with its tags.  A cross block attends to ``kv_x``
    after its self-attention."""
    h = x + attn.attention_forward(
        cfg, p.attn, layers.rmsnorm(p.ln1, x, cfg.norm_eps),
        positions=positions, causal=causal)
    if p.cross:
        h = gated_cross_residual(
            p, h, attn.attention_forward(
                cfg, p.xattn, layers.rmsnorm(p.ln_x, h, cfg.norm_eps),
                positions=positions, kv_x=kv_x, causal=False,
                use_rope=False))
    return _mlp_residual(cfg, p, h)


def gated_cross_residual(p: Block, h: torch.Tensor, xa: torch.Tensor
                         ) -> torch.Tensor:
    """h + tanh(xgate) x xa, the gate cast to the activations' dtype."""
    return h + torch.tanh(p.xgate).to(xa.dtype) * xa


def block_forward(cfg: ModelConfig, p: Block, x: torch.Tensor,
                  positions: torch.Tensor,
                  kv_x: Optional[torch.Tensor] = None, *,
                  causal: bool = True) -> torch.Tensor:
    """The block's output; an MoE block's auxiliary loss is dropped: it
    matters only to training."""
    return block_forward_aux(cfg, p, x, positions, kv_x, causal=causal)[0]


def _mlp_residual(cfg: ModelConfig, p: Block, h: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h + ffn(norm(h)), the MoE auxiliary loss or 0)."""
    hn = layers.rmsnorm(p.ln2, h, cfg.norm_eps)
    if cfg.is_moe:
        mo, aux = moe.moe_forward(cfg, p.moe, hn)
    else:
        mo = layers.swiglu(p.mlp, hn, layers.dtype_of(cfg.dtype),
                           skip=cfg.mlp_skip)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return tag("block_out", h + tag("mlp_out", mo)), aux


@functools.lru_cache(maxsize=64)
def memory_plan(cfg: ModelConfig, batch_tokens: int) -> CompiledMemoryPlan:
    """The default memory plan of ``cfg`` at this token count, whose
    checkpoint policy (None when ``cfg.remat`` is off) :func:`scan_blocks`
    installs: the reference's ``_remat_policy``."""
    return compile_plan(cfg, batch_tokens=batch_tokens)


class _Checkpointed:
    """Runs blocks in turn, each checkpointed under its policy when remat
    and autograd are on (``remat.checkpoint``, every region handed the one
    before it), or called plainly."""

    def __init__(self, cfg: ModelConfig):
        self.on = cfg.remat and torch.is_grad_enabled()
        self.region = None

    def __call__(self, policy, fn, *args):
        if not self.on:
            return fn(*args)
        out, self.region = remat.checkpoint(policy, fn, *args,
                                            prev=self.region)
        return out


def scan_blocks(cfg: ModelConfig, blocks, x: torch.Tensor,
                positions: torch.Tensor, *,
                kv_x: Optional[torch.Tensor] = None, causal: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_scan_blocks``: every block in turn, the auxiliary
    losses summed; each block checkpointed under the plan's policy when
    ``cfg.remat`` and autograd are on.  ``kv_x`` goes to the blocks'
    cross-attention and ``causal`` to their self-attention."""
    run = _Checkpointed(cfg)
    policy = memory_plan(cfg, x.shape[0] * x.shape[1]).offload_policy \
        if run.on else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    extra = () if kv_x is None else (kv_x,)
    for blk in blocks:
        x, a = run(policy, functools.partial(block_forward_aux, cfg, blk,
                                             causal=causal),
                   x, positions, *extra)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Decoder-only LM
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: ModelConfig, *,
            trainable: bool = False) -> "TransformerLM":
    """Random init with the reference's distributions, on ``gen.device``."""
    dt = layers.weight_dtype(cfg, trainable)
    pv = padded_vocab(cfg)
    tree: Tree = {
        "embed": layers.embedding_init(gen, pv, cfg.d_model, dtype=dt),
        "blocks": [block_init(gen, cfg, trainable=trainable)
                   for _ in range(cfg.n_layers)],
        "ln_f": layers.rmsnorm_init(cfg.d_model, device=gen.device),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = layers.dense_init(gen, cfg.d_model, pv, dtype=dt)
    return TransformerLM(cfg, tree, trainable=trainable)


def lm_specs(cfg: ModelConfig) -> Tree:
    """Logical axes of every parameter, the reference's ``lm_specs`` per
    layer (its stacked layer axis, unsharded, is the port's list)."""
    s: Tree = {"embed": layers.embedding_specs(),
               "blocks": [block_specs(cfg) for _ in range(cfg.n_layers)],
               "ln_f": layers.rmsnorm_specs()}
    if not cfg.tie_embeddings:
        s["unembed"] = layers.dense_specs("embed", "vocab")
    return s


def lm_decode_specs(cfg: ModelConfig) -> Tree:
    return attn.kv_cache_specs()


class TransformerLM(nn.Module):
    """Parameters of the decoder-only LM (dense or MoE);
    ``forward(tokens)`` gives all logits."""

    def __init__(self, cfg: ModelConfig, tree: Tree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"], trainable)
        blocks: List[Tree] = tree["blocks"]
        self.blocks = nn.ModuleList(Block(cfg, b, trainable=trainable)
                                    for b in blocks)
        self.ln_f = _param(tree["ln_f"], trainable)
        self.unembed = _param(tree["unembed"], trainable) \
            if "unembed" in tree else None

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lm_forward(self.cfg, self, tokens)


def lm_logits(cfg: ModelConfig, params: TransformerLM,
              x: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, padded_vocab); under a mesh that splits the
    vocabulary over ``model``, this rank's block of columns."""
    dt = layers.dtype_of(cfg.dtype)
    x = layers.rmsnorm(params.ln_f, x, cfg.norm_eps)
    if params.unembed is None:
        if C.split_over(params.embed, 0):
            x = C.copy_to(x)
        return layers.unembed(params.embed, x, dt)
    if C.split_over(params.unembed, 1):
        x = C.copy_to(x)
    return layers.dense(C.fetch(params.unembed), x, dt)


def lm_forward_aux(cfg: ModelConfig, params: TransformerLM,
                   tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``lm_forward``: tokens (B, S) -> (logits (B, S,
    padded_vocab), the summed MoE auxiliary loss)."""
    b, s = tokens.shape
    x = layers.embed(params.embed, tokens, layers.dtype_of(cfg.dtype))
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x, aux = scan_blocks(cfg, params.blocks, x, positions)
    return lm_logits(cfg, params, x), aux


def lm_forward(cfg: ModelConfig, params: TransformerLM,
               tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab)."""
    return lm_forward_aux(cfg, params, tokens)[0]


def _masked_fp32(logits: torch.Tensor, vocab: int, v0: int = 0
                 ) -> torch.Tensor:
    """fp32 logits (a copy), the padded ids masked by their global
    index (the block's columns start at ``v0``)."""
    lf = logits.float()
    if lf is logits:
        lf = lf.clone()
    if v0 + lf.shape[-1] > vocab:
        lf[..., max(vocab - v0, 0):] = -1e30   # mask padded ids
    return lf


class _SoftmaxXent(torch.autograd.Function):
    """This rank's share of the mean cross-entropy logsumexp(l) -
    l[target] over fp32 logits: the mean over its tokens divided by
    ``parts``, the number of ranks the batch is split over (1 on one
    device).  ``logits`` are its block of the vocabulary, starting at
    global column ``v0``: the padded columns are masked at -1e30 by their
    global index and, where ``split``, the maximum, the sum of
    exponentials and the target's logit are reduced over ``model``.  The
    backward forms (softmax - onehot) / (tokens x parts) on the block in
    one fp32 buffer instead of autograd's chain of full-vocabulary
    tensors, with no collective."""

    @staticmethod
    def forward(ctx, logits, targets, vocab, v0, parts, split):
        lf = _masked_fp32(logits, vocab, v0)
        local = targets - v0
        inside = (local >= 0) & (local < lf.shape[-1])
        gold = torch.gather(lf, -1, local.clamp(0, lf.shape[-1] - 1)
                            [..., None])[..., 0] * inside
        top = lf.amax(dim=-1)
        if split:
            top = C.all_reduce(top, "model", op="max")
        sumexp = lf.sub_(top[..., None]).exp_().sum(dim=-1)  # in place
        del lf
        if split:
            sumexp = C.all_reduce(sumexp, "model")
            gold = C.all_reduce(gold, "model")
        logz = top + torch.log(sumexp)
        ctx.save_for_backward(logits, targets, logz)
        ctx.cfg = (vocab, v0, targets.numel() * parts)
        return torch.mean(logz - gold) / parts

    @staticmethod
    def backward(ctx, g):
        logits, targets, logz = ctx.saved_tensors
        vocab, v0, n = ctx.cfg
        p = _masked_fp32(logits, vocab, v0).sub_(logz[..., None]).exp_()
        local = targets - v0
        inside = (local >= 0) & (local < p.shape[-1])
        idx = local.clamp(0, p.shape[-1] - 1)[..., None]
        p.scatter_(-1, idx, torch.gather(p, -1, idx)
                   - inside[..., None].to(p.dtype))
        p.mul_(g / n)
        return p.to(logits.dtype), None, None, None, None, None


def softmax_xent(cfg: ModelConfig, logits: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with padded-vocab masking, fp32 accumulation.

    Under a mesh: this rank's share of the global batch's mean (the mean
    over its tokens over the number of ranks the batch is split over; the
    shares sum to the mean over the batch axes), the vocabulary reduced
    over ``model`` where the logits hold a block of it."""
    mesh = R.current_mesh()
    parts = padded_vocab(cfg) // logits.shape[-1]
    v0 = mesh.coords().get("model", 0) * logits.shape[-1] if parts > 1 \
        else 0
    return _SoftmaxXent.apply(logits, targets.long(), cfg.vocab, v0,
                              R.batch_parts(), parts > 1)


def lm_loss(cfg: ModelConfig, params: TransformerLM, batch) -> torch.Tensor:
    """Next-token cross-entropy; an MoE config adds 0.01 x its auxiliary
    load-balancing loss.  Under a mesh each rank returns its share of the
    global batch's loss (the shares are summed over the batch axes), and
    the auxiliary loss, already the global one on every rank, is shared
    as the cross-entropy is."""
    logits, aux = lm_forward_aux(cfg, params, batch["tokens"])
    loss = softmax_xent(cfg, logits, batch["targets"])
    if cfg.is_moe:
        parts = R.batch_parts()
        loss = loss + 0.01 * (aux / parts if parts > 1 else aux)
    return loss


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
        x = _mlp_residual(cfg, p, x + ao)[0]
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
        x = _mlp_residual(cfg, p, x + ao)[0]
    return lm_logits(cfg, params, x[:, -1:])[:, 0], cache


# ---------------------------------------------------------------------------
# xLSTM stack (family: ssm)
# ---------------------------------------------------------------------------

def xlstm_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, per): ``n_groups`` groups of ``per`` mLSTM blocks, each
    followed by one sLSTM block (xlstm-1.3b: 6 groups of 7 + 1).  A stack
    without sLSTM blocks (``slstm_every = 0``, as the reference builds it)
    is one group of ``n_layers`` mLSTM blocks and no sLSTM block."""
    if not cfg.slstm_every:
        return 1, cfg.n_layers
    n_s = cfg.n_layers // cfg.slstm_every
    n_m = cfg.n_layers - n_s
    if not n_s or n_m % n_s:
        raise ValueError(f"{n_m} mLSTM blocks do not split into {n_s} groups")
    return n_s, n_m // n_s


def xlstm_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(mLSTM blocks, sLSTM blocks)."""
    n_groups, per = xlstm_layout(cfg)
    return n_groups * per, n_groups if cfg.slstm_every else 0


class MLSTMBlock(nn.Module):
    """Pre-norm mLSTM block: x + mlstm(norm(x))."""

    def __init__(self, tree: Tree, *, trainable: bool = False):
        super().__init__()
        self.ln = _param(tree["ln"], trainable)
        self.mlstm = _param_dict(tree["mlstm"], trainable)


class SLSTMBlock(nn.Module):
    """Pre-norm sLSTM block: x + slstm(norm(x))."""

    def __init__(self, tree: Tree, *, trainable: bool = False):
        super().__init__()
        self.ln = _param(tree["ln"], trainable)
        self.slstm = _param_dict(tree["slstm"], trainable)


def xlstm_init(gen: torch.Generator, cfg: ModelConfig, *,
               trainable: bool = False) -> "XLSTMLM":
    """Random init with the reference's distributions, on ``gen.device``."""
    dt = layers.weight_dtype(cfg, trainable)
    pv = padded_vocab(cfg)
    n_m, n_s = xlstm_counts(cfg)
    dev = gen.device
    tree: Tree = {
        "embed": layers.embedding_init(gen, pv, cfg.d_model, dtype=dt),
        "mblocks": [{"ln": layers.rmsnorm_init(cfg.d_model, device=dev),
                     "mlstm": xlstm.mlstm_init(gen, cfg,
                                               trainable=trainable)}
                    for _ in range(n_m)],
        "sblocks": [{"ln": layers.rmsnorm_init(cfg.d_model, device=dev),
                     "slstm": xlstm.slstm_init(gen, cfg,
                                               trainable=trainable)}
                    for _ in range(n_s)],
        "ln_f": layers.rmsnorm_init(cfg.d_model, device=dev),
        "unembed": layers.dense_init(gen, cfg.d_model, pv, dtype=dt),
    }
    return XLSTMLM(cfg, tree, trainable=trainable)


def xlstm_specs(cfg: ModelConfig) -> Tree:
    n_m, n_s = xlstm_counts(cfg)
    s: Tree = {
        "embed": layers.embedding_specs(),
        "mblocks": [{"ln": layers.rmsnorm_specs(),
                     "mlstm": xlstm.mlstm_specs()} for _ in range(n_m)],
        "sblocks": [{"ln": layers.rmsnorm_specs(),
                     "slstm": xlstm.slstm_specs()} for _ in range(n_s)],
        "ln_f": layers.rmsnorm_specs(),
        "unembed": layers.dense_specs("embed", "vocab"),
    }
    return s


class XLSTMLM(nn.Module):
    """Parameters of the xLSTM LM; ``forward(tokens)`` gives all logits.
    Served, it holds its matmul weights in the compute dtype, frozen;
    ``trainable=True`` holds every parameter in float32 with gradients."""

    def __init__(self, cfg: ModelConfig, tree: Tree, *,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"], trainable)
        self.mblocks = nn.ModuleList(MLSTMBlock(t, trainable=trainable)
                                     for t in tree["mblocks"])
        self.sblocks = nn.ModuleList(SLSTMBlock(t, trainable=trainable)
                                     for t in tree["sblocks"])
        self.ln_f = _param(tree["ln_f"], trainable)
        self.unembed = _param(tree["unembed"], trainable)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return xlstm_forward(self.cfg, self, tokens)


def _mlstm_block(cfg: ModelConfig, p: MLSTMBlock, x: torch.Tensor
                 ) -> torch.Tensor:
    return x + xlstm.mlstm_forward(cfg, p.mlstm,
                                   layers.rmsnorm(p.ln, x, cfg.norm_eps))


def _slstm_block(cfg: ModelConfig, p: SLSTMBlock, x: torch.Tensor
                 ) -> torch.Tensor:
    return x + xlstm.slstm_forward(cfg, p.slstm,
                                   layers.rmsnorm(p.ln, x, cfg.norm_eps))


def xlstm_forward(cfg: ModelConfig, params: XLSTMLM, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, padded_vocab).  With ``cfg.remat``
    under autograd every mLSTM and sLSTM block is checkpointed with
    nothing saved (recomputed from its input in the backward), as the
    reference's ``jax.checkpoint`` of ``mbody`` and ``sbody``."""
    n_groups, per = xlstm_layout(cfg)
    x = layers.embed(params.embed, tokens, layers.dtype_of(cfg.dtype))
    run = _Checkpointed(cfg)
    full = remat.FULL_RECOMPUTE
    for g in range(n_groups):
        for p in params.mblocks[g * per:(g + 1) * per]:
            x = run(full, functools.partial(_mlstm_block, cfg, p), x)
        if params.sblocks:
            x = run(full, functools.partial(_slstm_block, cfg,
                                            params.sblocks[g]), x)
    return lm_logits(cfg, params, x)


def xlstm_loss(cfg: ModelConfig, params: XLSTMLM, batch) -> torch.Tensor:
    """Next-token cross-entropy (the reference's ``xlstm_loss``)."""
    return softmax_xent(cfg, xlstm_forward(cfg, params, batch["tokens"]),
                        batch["targets"])


# ---- decode ----------------------------------------------------------------

def xlstm_decode_init(cfg: ModelConfig, batch: int, max_seq: int, *, device
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's layout: ``m`` holds C, n, m of every mLSTM block
    (xlstm-1.3b: C is (42, B, 4, 1024, 1024) float32), ``s`` holds h, c, n,
    m of every sLSTM block.  ``max_seq`` is unused: the state is O(1)."""
    n_m, n_s = xlstm_counts(cfg)
    st = {"m": xlstm.init_mlstm_state(cfg, batch, n_m, device=device)}
    if n_s:
        st["s"] = xlstm.init_slstm_state(cfg, batch, n_s, device=device)
    return st


def xlstm_decode_specs(cfg: ModelConfig) -> Tree:
    """The decode state's logical axes (the reference's)."""
    s: Tree = {"m": xlstm.mlstm_state_specs()}
    if cfg.slstm_every:
        s["s"] = xlstm.slstm_state_specs()
    return s


def xlstm_decode_step(cfg: ModelConfig, params: XLSTMLM, state,
                      tokens: torch.Tensor, cache_len: torch.Tensor):
    """tokens: (B,) new ids; ``cache_len`` is unused (recurrent state).

    Returns ``(logits (B, padded_vocab), state)``; the state is updated in
    place.
    """
    n_groups, per = xlstm_layout(cfg)
    x = layers.embed(params.embed, tokens[:, None],
                     layers.dtype_of(cfg.dtype))
    ms = state["m"]

    def mstep(i: int, x: torch.Tensor) -> torch.Tensor:
        p = params.mblocks[i]
        y, ms["C"][i], ms["n"][i], ms["m"][i] = xlstm.mlstm_decode_step(
            cfg, p.mlstm, layers.rmsnorm(p.ln, x, cfg.norm_eps),
            ms["C"][i], ms["n"][i], ms["m"][i])
        return x + y

    for g in range(n_groups):
        for i in range(g * per, (g + 1) * per):
            x = mstep(i, x)
        if not params.sblocks:
            continue
        p, ss = params.sblocks[g], state["s"]
        y, ss["h"][g], ss["c"][g], ss["n"][g], ss["m"][g] = \
            xlstm.slstm_decode_step(
                cfg, p.slstm, layers.rmsnorm(p.ln, x, cfg.norm_eps),
                ss["h"][g], ss["c"][g], ss["n"][g], ss["m"][g])
        x = x + y
    return lm_logits(cfg, params, x)[:, 0], state
