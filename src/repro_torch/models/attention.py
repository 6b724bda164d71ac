"""GQA attention: naive, blockwise and flash-kernel backends, plus the
KV-cache prefill and decode.

Port of ``repro/models/attention.py``.  Tensors are (B, S, H, hd) as in
the reference.  ``attention_forward`` is self-attention, or
cross-attention when it is given ``kv_x`` (keys and values projected
from the encoder's output or the image embeddings, non-causal, no rope),
and keeps the reference's dispatch: naive when the query length ``s <=
cfg.block_q`` (whatever the key length), else the flash kernel for
``attention_impl="pallas"`` and blockwise for "blockwise";
``attention_impl="skip"`` is the reference's cost-probe mode (no mixing,
no kernel: ``launch/probe.py``).  The kernel
takes GQA and Sq != Skv natively, so it gets the un-repeated K/V (same
function, less memory).

Under autograd the rotary q and k projections are one Function each
(:class:`_RotaryProjection`, saving only its inputs and computing its own
backward), and q and the attention output are tagged ``qkv`` and
``attn_out`` where the reference tags them, so a checkpointed block's
replay skips what its policy kept (``repro_torch.core.remat``).

The KV cache is updated in place: ``prefill_attention`` and
``decode_attention`` write into the cache slices they are given and
return them.  The decode write at ``cache_len`` is an indexed store where
the reference uses a one-hot blend; the values are identical.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat import produce
from repro_torch.core.remat_policy import tag
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.sharding import api
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R

NEG_INF = -1e30


def attention_init(gen: torch.Generator, cfg: ModelConfig, *,
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": layers.dense_init(gen, d, cfg.n_heads * hd, dtype=dtype),
        "wk": layers.dense_init(gen, d, cfg.n_kv_heads * hd, dtype=dtype),
        "wv": layers.dense_init(gen, d, cfg.n_kv_heads * hd, dtype=dtype),
        "wo": layers.dense_init(gen, cfg.n_heads * hd, d, dtype=dtype),
    }


def attention_specs():
    """The reference's: the weights' out-dims are logical ``qkv``, which
    its rules do not map (so they are replicated over ``model``); heads
    and kv heads are activation axes.  Where the ranks split the heads
    (:func:`head_split`), each projects only its own through every weight,
    so every weight's gradient is partial over ``model``."""
    return api.SplitSpecs({"wq": layers.dense_specs("embed", "qkv"),
                           "wk": layers.dense_specs("embed", "qkv"),
                           "wv": layers.dense_specs("embed", "qkv"),
                           "wo": layers.dense_specs("qkv", "embed")},
                          lambda cfg, shardings: tuple(shardings)
                          if head_split(cfg)[1] < cfg.n_heads else ())


def kv_cache_specs():
    return {"k": (None, "batch", "kv_seq", "kv_heads", None),
            "v": (None, "batch", "kv_seq", "kv_heads", None)}


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,KV*groups,hd) by repeating each kv head."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd) \
        .reshape(b, s, kv * groups, hd)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,H,hd).  O(Sq*Sk) memory: small seq only."""
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(qi < ki, NEG_INF)
    if kv_len is not None:
        keep = torch.arange(sk, device=q.device)[None, None, None, :] \
            < kv_len[:, None, None, None]
        scores = scores.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, block_q: int = 512,
                        block_kv: int = 1024, q_offset: int = 0
                        ) -> torch.Tensor:
    """Flash-style online-softmax attention in plain PyTorch over KV blocks.

    Memory O(Sq * block_kv) instead of O(Sq * Sk).  Like the reference it
    visits every kv block (masked ones add exact zeros).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    block_q = min(block_q, sq)
    block_kv = min(block_kv, sk)
    n_q = -(-sq // block_q)
    n_kv = -(-sk // block_kv)
    dev = q.device
    outs = []
    for qi in range(n_q):
        q_blk = q[:, qi * block_q:(qi + 1) * block_q]
        q_pos = qi * block_q + torch.arange(q_blk.shape[1], device=dev) \
            + q_offset
        acc = torch.zeros(b, h, q_blk.shape[1], hd, device=dev)
        m = torch.full((b, h, q_blk.shape[1]), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        for ki in range(n_kv):
            k_blk = k[:, ki * block_kv:(ki + 1) * block_kv]
            v_blk = v[:, ki * block_kv:(ki + 1) * block_kv]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk).float() * scale
            if causal:
                k_pos = ki * block_kv + torch.arange(k_blk.shape[1],
                                                     device=dev)
                s = s.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), v_blk).float()
            m = m_new
        out = acc / l[..., None].clamp_min(1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


class _RotaryProjection(torch.autograd.Function):
    """rope((x @ w).view(B, S, heads, hd)) in the compute dtype ``dt``:
    the op-by-op value, with the vjp written out (rotate back in fp32,
    round to ``dt``, then the matmul's two products) so that the Function
    saves only x, w and the positions."""

    @staticmethod
    def forward(ctx, x, w, positions, theta, heads, dt):
        ctx.save_for_backward(x, w, positions)
        ctx.cfg = (theta, heads, dt)
        return produce(lambda: _project(x, w, positions, theta, heads, dt))

    @staticmethod
    def backward(ctx, g):
        x, w, positions = ctx.saved_tensors
        theta, heads, dt = ctx.cfg
        b, s, d = x.shape
        cos, sin = layers.rope_cos_sin(positions, g.shape[-1], theta)
        g1, g2 = g.float().chunk(2, dim=-1)
        dy = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)
        dy = dy.to(dt).reshape(b * s, -1)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (dy @ w.to(dt).T).view(b, s, d).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.to(dt).reshape(b * s, d).T @ dy).to(w.dtype)
        return dx, dw, None, None, None, None


def _project(x, w, positions, theta, heads, dt):
    b, s, _ = x.shape
    return layers.apply_rope(layers.dense(w, x, dt).view(b, s, heads, -1),
                             positions, theta)


def _rotary_projection(x, w, positions, theta, heads, dt):
    """The Function under autograd; outside it (serving) the plain ops."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RotaryProjection.apply(x, w, positions, theta, heads, dt)
    return _project(x, w, positions, theta, heads, dt)


def attention_forward(cfg: ModelConfig, params, x: torch.Tensor, *,
                      positions: torch.Tensor,
                      kv_x: Optional[torch.Tensor] = None,
                      causal: bool = True, use_rope: bool = True
                      ) -> torch.Tensor:
    """Attention sub-layer: proj -> rope -> attend -> out-proj.

    ``kv_x`` (B, Skv, d) switches to cross-attention: K and V come from
    it, rope is not applied and the call is non-causal.  ``use_rope=False``
    drops rope from self-attention too.

    Under a mesh whose rules put ``heads`` over ``model`` (the reference's
    ``constrain`` of q, k, v to heads / kv heads), each rank computes its
    own heads (:func:`head_split`): a column block of the replicated
    ``wq``, ``wk``, ``wv`` (FSDP-gathered over data where the placement
    shards them), attention on those heads, and a row block of ``wo``
    whose partial products are summed over ``model``."""
    dt = layers.dtype_of(cfg.dtype)
    b, s, _ = x.shape
    hd = cfg.head_dim
    q0, h, k0, kv, kv_index = head_split(cfg)
    split = R.current_mesh() is not None and bool(R.current_rules()["heads"])
    if split:
        x = C.copy_to(x)
        kv_x = None if kv_x is None else C.copy_to(kv_x)
    wq = C.fetch(params["wq"], 1, q0 * hd, h * hd)
    wk = C.fetch(params["wk"], 1, k0 * hd, kv * hd)
    wv = C.fetch(params["wv"], 1, k0 * hd, kv * hd)
    wo = C.fetch(params["wo"], 0, q0 * hd, h * hd)
    kv_src = x if kv_x is None else kv_x
    skv = kv_src.shape[1]
    if use_rope and kv_x is None:
        q = _rotary_projection(x, wq, positions, cfg.rope_theta, h, dt)
        k = _rotary_projection(x, wk, positions, cfg.rope_theta, kv, dt)
    else:
        q = layers.dense(wq, x, dt).view(b, s, h, hd)
        k = layers.dense(wk, kv_src, dt).view(b, skv, kv, hd)
    v = layers.dense(wv, kv_src, dt).view(b, skv, kv, hd)
    if kv_index is not None:
        # the local q heads' groups are not a whole block of local kv
        # heads: give each q head its own group's k and v
        k, v = k[:, :, kv_index], v[:, :, kv_index]
        kv = h
    q = tag("qkv", q)
    causal = causal and kv_x is None
    impl = cfg.attention_impl
    if impl not in ("naive", "pallas", "blockwise", "skip"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    if impl == "skip":
        # cost-probe mode (launch/probe.py): no S^2 mixing and no kernel;
        # the flash kernel's cost is added analytically (launch/costs.py).
        # The reference's o = q + v is defined where Sq == Skv; a cross
        # call with other lengths (where the reference's sum cannot
        # broadcast) adds v's mean over the keys instead
        v = _repeat_kv(v, h // kv)
        o = q + (v if skv == s else v.mean(dim=1, keepdim=True))
    elif impl == "pallas" and s > cfg.block_q:
        o = flash_attention(q, k, v, causal=causal, block_q=cfg.block_q,
                            block_kv=cfg.block_kv)
    elif impl == "blockwise" and s > cfg.block_q:
        o = blockwise_attention(q, _repeat_kv(k, h // kv),
                                _repeat_kv(v, h // kv), causal=causal,
                                block_q=cfg.block_q, block_kv=cfg.block_kv)
    else:
        o = naive_attention(q, _repeat_kv(k, h // kv),
                            _repeat_kv(v, h // kv), causal=causal)
    o = tag("attn_out", o.contiguous())
    out = layers.dense(wo, o.view(b, s, h * hd), dt)
    return C.reduce_from(out) if split else out


def head_split(cfg: ModelConfig):
    """(first q head, q heads, first kv head, kv heads, kv_index) this rank
    computes.  Without a mesh, or when the rules keep ``heads`` off the
    model axis, every head.  Otherwise the rank's block of the q heads
    along ``model``, and the kv heads their GQA groups reach: when those
    q heads fall into whole groups of equal size the kv block is used as
    it is (``kv_index`` None; with kv heads that divide the model axis,
    the rank's own block of them); else ``kv_index`` gives each local q
    head its own global group among the projected kv heads."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    mesh = R.current_mesh()
    if mesh is None or not R.current_rules().get("heads"):
        return 0, h, 0, kv, None
    parts = mesh.shape.get("model", 1)
    hl = h // parts
    q0 = mesh.coords().get("model", 0) * hl
    groups = h // kv
    owner = [(q0 + j) // groups for j in range(hl)]
    k0, kl = owner[0], owner[-1] - owner[0] + 1
    local = [o - k0 for o in owner]
    if hl % kl == 0 and local == [j // (hl // kl) for j in range(hl)]:
        return q0, hl, k0, kl, None
    return q0, hl, k0, kl, local


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, n_layers: int,
                  dtype: torch.dtype = torch.bfloat16, *, device
                  ) -> Dict[str, torch.Tensor]:
    shape = (n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attention(cfg: ModelConfig, params, x: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched prefill: project/rope the whole prompt, write it into
    ``cache[:, :S]`` (in place), attend causally over the stored K/V.

    x: (B, S, d); cache_k/v: (B, max_seq, KV, hd), empty (the prompt
    starts at position 0).  Returns (out, cache_k, cache_v).
    """
    dt = layers.dtype_of(cfg.dtype)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.dense(params["wq"], x, dt).view(b, s, h, hd)
    k = layers.dense(params["wk"], x, dt).view(b, s, kv, hd)
    v = layers.dense(params["wv"], x, dt).view(b, s, kv, hd)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    cache_k[:, :s] = k.to(cache_k.dtype)
    cache_v[:, :s] = v.to(cache_v.dtype)
    # attend over the *stored* K/V so dtype rounding matches decode exactly
    o = naive_attention(q, _repeat_kv(cache_k[:, :s], h // kv),
                        _repeat_kv(cache_v[:, :s], h // kv), causal=True)
    return layers.dense(params["wo"], o.reshape(b, s, h * hd), dt), \
        cache_k, cache_v


def decode_attention(cfg: ModelConfig, params, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     cache_len: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: write K/V at ``cache_len`` (in place), attend
    over the prefix.

    x: (B, 1, d); cache_k/v: (B, max_seq, KV, hd); cache_len: (B,) current
    lengths.  Returns (out, cache_k, cache_v).

    Under a mesh the cache is this rank's block of the reference's
    placement (``kv_cache_specs``).  Where it holds a block of the kv
    heads, the rank projects, writes and attends its heads' groups
    (:func:`decode_heads`) and ``wo``'s row block gives a partial output
    summed over ``model``.  Where the rules put the cache's positions
    over mesh axes (``kv_seq``: ``model`` for kv heads that do not divide
    it, and then every rank computes all heads; ``data`` for a batch that
    does not split; or both), the rank's block of positions starts at
    its index over those axes times the block's length, only the rank
    whose block holds position ``cache_len[b]`` writes sequence b's new
    row, and each attends its heads over its block of positions: the
    blocks' softmax statistics are combined over those axes (and only
    those) by an all-reduce of the row maxima and one of the (numerator,
    denominator) sums, the flash-decode combine."""
    dt = layers.dtype_of(cfg.dtype)
    b = x.shape[0]
    hd = cfg.head_dim
    q0, h, k0, kv = decode_heads(cfg, cache_k.shape[2])
    split = h < cfg.n_heads
    q = layers.dense(C.fetch(params["wq"], 1, q0 * hd, h * hd), x,
                     dt).view(b, 1, h, hd)
    k = layers.dense(C.fetch(params["wk"], 1, k0 * hd, kv * hd), x,
                     dt).view(b, 1, kv, hd)
    v = layers.dense(C.fetch(params["wv"], 1, k0 * hd, kv * hd), x,
                     dt).view(b, 1, kv, hd)
    pos = cache_len[:, None]
    q = layers.apply_rope(q, pos, cfg.rope_theta)
    k = layers.apply_rope(k, pos, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    seq_axes = _position_axes()
    if seq_axes:
        s0 = cache_k.shape[1] * _block_index(seq_axes)
        local = cache_len - s0
        mine = (local >= 0) & (local < cache_k.shape[1])
        cache_k[rows[mine], local[mine]] = k[mine, 0].to(cache_k.dtype)
        cache_v[rows[mine], local[mine]] = v[mine, 0].to(cache_v.dtype)
        o = _combined_attention(q, _repeat_kv(cache_k, h // kv),
                                _repeat_kv(cache_v, h // kv), s0,
                                cache_len + 1, seq_axes)
    else:
        cache_k[rows, cache_len] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, cache_len] = v[:, 0].to(cache_v.dtype)
        o = naive_attention(q, _repeat_kv(cache_k, h // kv),
                            _repeat_kv(cache_v, h // kv), causal=False,
                            kv_len=cache_len + 1)
    out = layers.dense(C.fetch(params["wo"], 0, q0 * hd, h * hd),
                       o.reshape(b, 1, h * hd), dt)
    return (C.reduce_from(out) if split else out), cache_k, cache_v


def decode_heads(cfg: ModelConfig, kv_local: int):
    """(first q head, q heads, first kv head, kv heads) of a decode step
    whose cache (or cross cache) holds ``kv_local`` kv heads: its kv block
    and their GQA groups' q heads where that is a block of the kv heads
    (split over ``model``), else every head."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if kv_local == kv:
        return 0, h, 0, kv
    k0 = C.block_start_of(kv_local, kv)
    groups = h // kv
    return k0 * groups, kv_local * groups, k0, kv_local


def _position_axes() -> Tuple[str, ...]:
    """The mesh axes of more than one rank the active rules put the KV
    cache's positions over (``kv_seq``, in rule order): ``model`` where
    the kv heads do not divide it, ``data`` where the batch does not
    split (batch-1 long context), or both; () without a mesh."""
    mesh = R.current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in R.current_rules().get("kv_seq") or ()
                 if mesh.shape.get(a, 1) > 1)


def _block_index(axes: Tuple[str, ...]) -> int:
    """This rank's block of a dim cut over ``axes`` row-major (the first
    axis slowest), as a placement over them cuts it."""
    mesh = R.current_mesh()
    coords = mesh.coords()
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def _combined_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        s0: int, kv_len: torch.Tensor,
                        axes: Tuple[str, ...]) -> torch.Tensor:
    """One query row against this rank's block of cache positions (global
    index ``s0`` on), the blocks of every rank along ``axes`` combined as
    :func:`naive_attention` computes the whole row: the global row maximum
    and the sum of exp(score - max) (an all-reduce each, over all of
    ``axes`` at once where they span the mesh), the probabilities rounded
    to q's dtype as its softmax's are, then each block's probabilities x
    v summed over the blocks in fp32 (one more all-reduce) and rounded
    once.  A block that holds no
    position below ``kv_len`` adds zeros.
    q: (B, 1, H, hd); k, v: (B, S_block, H, hd) -> (B, 1, H, hd)."""
    hd = q.shape[-1]
    sk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() \
        * (1.0 / math.sqrt(hd))
    keep = (s0 + torch.arange(sk, device=q.device))[None, None, None, :] \
        < kv_len[:, None, None, None]
    scores = scores.masked_fill(~keep, NEG_INF)
    top = C.all_reduce(scores.amax(dim=-1, keepdim=True), axes, op="max")
    p = torch.exp(scores - top)
    den = C.all_reduce(p.sum(dim=-1, keepdim=True), axes)
    probs = (p / den).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return C.all_reduce(out, axes).to(q.dtype)
