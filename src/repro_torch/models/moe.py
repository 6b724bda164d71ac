"""Mixture-of-Experts FFN (GShard-style top-k token-choice routing with
capacity).

Port of ``repro/models/moe.py``.  Tokens are grouped (one group per
sequence, or per ``MAX_GROUP`` tokens of a longer one); each group sends
at most ``capacity`` tokens to each expert, and a token an expert has no
room for gets nothing from that expert (its output falls back to the
residual stream).  The router runs in fp32.

Both of the reference's dispatch implementations are here: ``einsum``
(one-hot dispatch and combine tensors, the configs' default) and
``gather`` (index gathers, no dispatch products).  Either way every
expert's gate/up half, ``silu(x_e gate_e) * (x_e up_e)``, is the fused
SwiGLU kernel's function, and all experts of a layer go through
``kernels/fused_swiglu`` as one batched launch (x (E, G·C, d), gate and up
(E, d, f)); the down projection and the dispatch/combine products stay
matmuls, as the reference leaves them to XLA.  ``expert_in`` and
``mlp_hidden`` are tagged where the reference tags them.

Under a mesh whose placement splits the experts over ``model`` (the
reference's ``constrain`` of the dispatch and the expert tensors to
``"expert"``), each rank builds only its experts' slice of the dispatch
(or of ``slot_token``), runs the kernel's expert form on its experts,
combines only their outputs, and the partial outputs are summed over
``model``.  The router is replicated: every rank routes every token of
its rows, and its gradient through the combine is partial per rank (the
step sums it over ``model``).  The load-balancing loss is a product of
two means over the micro-batch's global tokens, so both fractions are
summed over the batch axes (:func:`_global_mean`); its gradient, equal on
every ``model`` rank, is scaled by 1 / ranks so that the sum over
``model`` counts it once.
The reference's cost-probe ``moe_ffn_skip`` mode (``launch/probe.py``)
bypasses the expert FFN of the ``einsum`` dispatch (expert_out =
expert_in), as the reference's does; the ``gather`` dispatch ignores it,
as the reference's does.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat_policy import tag
from repro_torch.kernels.fused_swiglu.ops import fused_swiglu
from repro_torch.models import layers
from repro_torch.sharding import api
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R

MAX_GROUP = 4096  # tokens per dispatch group: bounds capacity-buffer size


def moe_init(gen: torch.Generator, cfg: ModelConfig, *,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's distributions: router (d, E) ~ N(0, 1/d), kept
    float32 (the router runs in fp32); gate, up (E, d, f) ~ N(0, 1/d) and
    down (E, f, d) ~ N(0, 1/f), drawn in float32 and held in ``dtype``."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "router": layers.dense_init(gen, d, e),
        "gate": layers.normal(gen, (e, d, f), s, dtype),
        "up": layers.normal(gen, (e, d, f), s, dtype),
        "down": layers.normal(gen, (e, f, d), 1.0 / math.sqrt(f), dtype),
    }


def moe_specs():
    """Where the placement splits the experts over ``model``
    (:func:`expert_block`), each rank combines only its own experts'
    outputs, so the gradient it takes back to the replicated router is
    partial over ``model``."""
    return api.SplitSpecs({"router": layers.dense_specs("embed", None),
                           "gate": ("expert", "embed", "mlp"),
                           "up": ("expert", "embed", "mlp"),
                           "down": ("expert", "mlp", "embed")},
                          lambda cfg, shardings: ("router",)
                          if C.split_over(shardings["gate"], 0) else ())


def _top_k_mask(router_probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G,S,E) probs -> (G,S,E) selection mask and renormalised weights."""
    _, topi = torch.topk(router_probs, k, dim=-1)               # (G,S,k)
    mask = torch.zeros_like(router_probs).scatter_(-1, topi, 1.0)
    weights = router_probs * mask
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    return mask, weights


def _expert_ffn(params, expert_in: torch.Tensor, dt: torch.dtype
                ) -> torch.Tensor:
    """(E, G, C, d) expert inputs -> (E, G, C, d) expert outputs: the
    SwiGLU FFN of every expert (of this rank's experts under a mesh that
    splits them), its gate/up half in one kernel launch."""
    e, g, c, d = expert_in.shape
    hidden = fused_swiglu(expert_in.reshape(e, g * c, d),
                          C.fetch(params["gate"]).to(dt),
                          C.fetch(params["up"]).to(dt))
    hidden = tag("mlp_hidden", hidden)
    return torch.bmm(hidden, C.fetch(params["down"]).to(dt)) \
        .reshape(e, g, c, d)


def _global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over dims (0, 1) of ``t`` (G, S, E) across the rows of
    every rank of the batch axes (each holds as many groups)."""
    axes = R.current_rules().get("batch") or () \
        if R.current_mesh() is not None else ()
    total = t.sum(dim=(0, 1))
    parts = 1
    for axis in axes:
        total = C.shared_sum(total, axis)
        parts *= R.current_mesh().shape.get(axis, 1)
    return total / (t.shape[0] * t.shape[1] * parts) if parts > 1 \
        else t.mean(dim=(0, 1))


class _ScaleGrad(torch.autograd.Function):
    """The identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def expert_block(cfg: ModelConfig, params) -> Tuple[int, int]:
    """(first expert, experts) of this rank: its block of the experts
    where the placement splits them over ``model``, else all of them."""
    if not C.split_over(params["gate"], 0):
        return 0, cfg.n_experts
    el = params["gate"].shape[0]
    return C.block_start(params["gate"], 0), el


def moe_forward(cfg: ModelConfig, params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d) in the compute dtype, fp32 aux-loss scalar.

    Dispatch groups are sub-sequences of at most MAX_GROUP tokens: the
    (G, S_g, E, C) one-hot buffers scale with S_g * C ~ S_g^2 * k / E, so
    long sequences are regrouped before routing (routing is per token, so
    this is exact; capacity is per group).
    """
    if cfg.moe_impl not in ("einsum", "gather"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    dt = layers.dtype_of(cfg.dtype)
    e0, el = expert_block(cfg, params)
    split = el < cfg.n_experts
    mesh = R.current_mesh()
    if mesh is not None and any(mesh.shape.get(a, 1) > 1 for a in
                                R.current_rules().get("seq") or ()):
        raise NotImplementedError(
            "MoE dispatch groups are whole sequences (or MAX_GROUP tokens of "
            "one): a rank's block of a sequence split over the mesh does "
            "not form them (the reference's rules never split one)")
    if split:
        x = C.copy_to(x)
    b0, s0, d = x.shape
    if s0 > MAX_GROUP:
        if s0 % MAX_GROUP:
            raise ValueError(f"a sequence of {s0} tokens does not split "
                             f"into groups of {MAX_GROUP}")
        x = x.reshape(b0 * (s0 // MAX_GROUP), MAX_GROUP, d)
    g, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    capacity = int(math.ceil(s * k / e * cfg.capacity_factor))
    capacity = max(capacity, 1)

    router_logits = x.float() @ C.fetch(params["router"]).float()  # (G,S,E)
    probs = torch.softmax(router_logits, dim=-1)
    mask, weights = _top_k_mask(probs, k)

    # load-balancing auxiliary loss (Switch): E * sum(f_e * p_e), each
    # fraction a mean over the micro-batch's global tokens
    frac_tokens = _global_mean(mask)                            # (E,)
    frac_probs = _global_mean(probs)                            # (E,)
    aux_loss = e * torch.sum(frac_tokens * frac_probs)
    chosen = weights                            # every expert's weights
    if split:
        # every model rank computes the whole term: count its gradient once
        aux_loss = _ScaleGrad.apply(aux_loss, el / e)
        # from here on only this rank's experts
        mask, weights = mask[..., e0:e0 + el], weights[..., e0:e0 + el]

    # position of each token within its expert's capacity buffer (an fp32
    # cumsum, as the reference's: exact for groups of up to 2^24 tokens)
    pos_in_expert = torch.cumsum(mask, dim=1) * mask - 1.0      # (G,S,E)
    in_capacity = (pos_in_expert < capacity) & (mask > 0)
    pos_clipped = torch.clamp(pos_in_expert, 0, capacity - 1).long()
    xs = x.to(dt)

    if cfg.moe_impl == "gather":
        # slot_token[g, e, c] = index of the token in slot c of expert e; a
        # stable sort, as jnp.argsort's
        order = torch.argsort(
            torch.where(in_capacity, pos_clipped, s + 1), dim=1,
            stable=True)                                        # (G,S,E)
        slot_token = order[:, :capacity, :].permute(2, 0, 1)    # (E,G,C)
        token_valid = torch.gather(in_capacity.permute(2, 0, 1), 2,
                                   slot_token)                  # (E,G,C)
        groups = torch.arange(g, device=x.device)
        expert_in = xs[groups[None, :, None], slot_token] \
            * token_valid[..., None].to(dt)                     # (E,G,C,d)
        expert_in = tag("expert_in", expert_in)
        expert_out = _expert_ffn(params, expert_in, dt)         # (E,G,C,d)

        # combine: for each token, gather its top-k expert outputs (under
        # a split, those of its choices that are this rank's experts)
        topv, topi = torch.topk(chosen, k, dim=-1)              # (G,S,k)
        if split:
            mine = (topi >= e0) & (topi < e0 + el)
            topi = (topi - e0).clamp(0, el - 1)
        tok_pos = torch.gather(pos_clipped, 2, topi)            # (G,S,k)
        tok_ok = torch.gather(in_capacity, 2, topi)             # (G,S,k)
        if split:
            tok_ok = tok_ok & mine
        picked = expert_out[topi, groups[:, None, None],
                            tok_pos]                    # (G,S,k,d)
        out = torch.sum(picked * (topv * tok_ok).to(dt)[..., None], dim=2)
        out = out.reshape(b0, s0, d).to(dt)
        return (C.reduce_from(out) if split else out), aux_loss.float()

    # dispatch: (G,S,E,C) one-hot over capacity slots, built in the compute
    # dtype (an int64 one_hot at the prefill step's shape would take 4x the
    # bytes); 1 at a token's slot when it is in capacity, else all 0
    dispatch = torch.zeros(g, s, el, capacity, dtype=dt, device=x.device)
    dispatch.scatter_(3, pos_clipped[..., None], in_capacity[..., None].to(dt))
    combine = dispatch * weights[..., None].to(dt)

    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xs)    # (E,G,C,d)
    expert_in = tag("expert_in", expert_in)
    if cfg.moe_ffn_skip:
        # cost-probe mode: the fused expert FFN's cost is added
        # analytically (launch/costs.py)
        expert_out = expert_in
    else:
        expert_out = _expert_ffn(params, expert_in, dt)         # (E,G,C,d)
    out = torch.einsum("gsec,egcd->gsd", combine, expert_out)
    out = out.reshape(b0, s0, d).to(dt)
    return (C.reduce_from(out) if split else out), aux_loss.float()
