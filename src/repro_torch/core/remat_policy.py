"""Joint keep / recompute / offload planning for tagged intermediates —
NNTrainer's lifespan analysis adapted to the TPU memory hierarchy.

On-device NNTrainer packs activations into a planned arena because embedded
RAM is the binding constraint.  On a TPU pod the binding constraint is HBM
per chip, and the degree of freedom is not *where* a tensor lives but what
happens to it between its forward write and its backward read.  Per named
intermediate there are three choices, each with a step-time price:

    keep       — stays resident in HBM; free at step time, but consumes
                 budget bytes for the whole Forward+CalcGrad lifespan;
    recompute  — Forward-only lifespan; the backward pass rebuilds it at
                 ``recompute_flops / device FLOP/s`` seconds;
    offload    — proactive swap to pinned host memory (NNTrainer §6); the
                 round trip costs ``2 * bytes / host-DMA bandwidth`` seconds
                 and vacates the HBM bytes during the gap.

:func:`plan_joint_policy` solves the three-way problem *jointly*: keeping an
intermediate is worth the cheaper of its two eviction prices, so the keep
set is the knapsack maximising evicted-cost-avoided under the per-layer HBM
budget (solved exactly for the small per-block tag sets, greedily by
cost-density beyond that), and every evicted intermediate takes whichever
eviction lane — recompute or offload — is cheaper under the
:class:`~repro_torch.core.plan.MemoryPlanConfig` hardware cost model
(``dma_gbps``, ``device_tflops``).  The output is a
:class:`RematPlan` with honest accounting (``recompute_flops_per_layer``,
``offload_dma_bytes_per_layer``).

The reference turns a plan into a ``jax.checkpoint`` policy
(``RematPlan.policy``) and names intermediates with ``tag``; here the
policy is a :class:`CheckpointPolicy` (which names to keep, which to
offload, the rest recomputed) and :mod:`repro_torch.core.remat` realises
it around each block with saved-tensor hooks.  The deprecated two-knob
``plan_checkpoint_policy`` and ``plan_for_config`` shims are not carried
over.

Tag names used across the models:

    attn_in   — block input (always cheap to keep: residual stream)
    qkv       — projected q/k/v
    attn_out  — attention output
    mlp_in    — post-norm MLP input
    mlp_hidden— SwiGLU hidden (the big one: d_ff wide)
    mlp_out   — MLP output
    expert_in — MoE dispatched tokens
    ssm_state — SSM chunk states
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

# Hardware cost-model defaults: a TPU-class accelerator (bf16 matmul
# throughput) attached to host memory over a PCIe-class link.  Overridable
# per compile via MemoryPlanConfig(dma_gbps=..., device_tflops=...) or per
# architecture via the same-named ModelConfig fields.
DEFAULT_DMA_GBPS = 32.0
DEFAULT_DEVICE_TFLOPS = 200.0

# Exact knapsack cutoff: per-block tag sets are tiny (4-8 names), so the
# optimal keep set is found by subset enumeration; beyond this the planner
# falls back to the greedy cost-density fill.
_EXACT_KNAPSACK_MAX_ITEMS = 16

KEEP = "keep"
RECOMPUTE = "recompute"
OFFLOAD = "offload"


@dataclasses.dataclass(frozen=True)
class Intermediate:
    """One named intermediate inside a (scanned) layer."""
    name: str
    bytes_per_layer: int       # bf16 bytes per layer at the planned shape
    recompute_flops: float     # FLOPs to rebuild it in backward if dropped


@dataclasses.dataclass
class RematPlan:
    """Per-layer keep/recompute/offload decisions with honest accounting.

    ``dropped`` holds the intermediates the backward pass recomputes and
    ``offloaded`` the ones round-tripped through pinned host memory; their
    union is exactly the budget-missing set (no decision is ever erased).
    ``recompute_flops_per_layer`` sums over ``dropped`` only and
    ``offload_dma_bytes_per_layer`` counts both DMA directions over
    ``offloaded`` — the two observable prices a plan pays.
    ``est_step_time_s_per_layer`` is their combined step-time estimate under
    the hardware cost model the plan was made with (zero DMA contribution
    when that model priced DMA as free — see :func:`plan_step_time_s` to
    re-price a plan under an honest model).
    """

    saved: Tuple[str, ...]
    dropped: Tuple[str, ...]
    saved_bytes_per_layer: int
    recompute_flops_per_layer: float
    # Names swapped to pinned host memory instead of recomputed — the
    # EO-analysis offload schedule's decision set, lowered to XLA via
    # ``repro_torch.core.offload.offload_policy``.
    offloaded: Tuple[str, ...] = ()
    offload_dma_bytes_per_layer: int = 0
    est_step_time_s_per_layer: float = 0.0

    def decisions(self) -> Dict[str, str]:
        """Per-intermediate choice: name -> keep | recompute | offload."""
        out = {n: KEEP for n in self.saved}
        out.update({n: RECOMPUTE for n in self.dropped})
        out.update({n: OFFLOAD for n in self.offloaded})
        return out

    def policy(self) -> "CheckpointPolicy":
        """The checkpoint policy saving (and offloading) the planned names:
        the reference's ``save_only_these_names`` /
        ``save_and_offload_only_these_names``."""
        return CheckpointPolicy(saved=self.saved, offloaded=self.offloaded)


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Which tagged intermediates a checkpointed block keeps on the device
    (``saved``) and which it offloads to host memory (``offloaded``);
    every other intermediate, tagged or not, is recomputed in the
    backward."""

    saved: Tuple[str, ...] = ()
    offloaded: Tuple[str, ...] = ()

    def decision(self, name: str) -> str:
        if name in self.offloaded:
            return OFFLOAD
        if name in self.saved:
            return KEEP
        return RECOMPUTE


def _lane_costs_s(i: Intermediate, dma_gbps: float,
                  device_tflops: float) -> Tuple[float, float]:
    """(recompute, offload) step-time prices in seconds for one eviction.

    A non-positive rate means that lane is unusable (infinite price):
    ``dma_gbps=0`` is "no DMA engine" and forces every eviction down the
    recompute lane; ``dma_gbps=inf`` is the deprecated free-DMA pricing.
    """
    recompute_s = math.inf if device_tflops <= 0 \
        else i.recompute_flops / (device_tflops * 1e12)
    if math.isinf(dma_gbps):
        offload_s = 0.0
    elif dma_gbps <= 0:
        offload_s = math.inf
    else:
        offload_s = 2.0 * i.bytes_per_layer / (dma_gbps * 1e9)
    return recompute_s, offload_s


def _evict_cost_s(i: Intermediate, *, offload: bool, dma_gbps: float,
                  device_tflops: float) -> Tuple[float, str]:
    """Cheapest eviction lane for one intermediate: (seconds, lane)."""
    recompute_s, offload_s = _lane_costs_s(i, dma_gbps, device_tflops)
    if not offload:
        return recompute_s, RECOMPUTE
    # ties go to the offload lane so the deprecated free-DMA mode keeps the
    # old offload-everything decision set
    if offload_s <= recompute_s:
        return offload_s, OFFLOAD
    return recompute_s, RECOMPUTE


def _greedy_keep_set(intermediates: Sequence[Intermediate],
                     budget_bytes_per_layer: int,
                     evict_s: Dict[str, float]) -> List[str]:
    """Greedy fill: highest avoided-cost per byte first, recompute density
    as the tiebreak — with every avoided cost zero (the deprecated free-DMA
    mode) this degenerates to the historical flops-per-byte order exactly.
    """
    ranked = sorted(
        intermediates,
        key=lambda i: (evict_s[i.name] / max(i.bytes_per_layer, 1),
                       i.recompute_flops / max(i.bytes_per_layer, 1)),
        reverse=True,
    )
    saved: List[str] = []
    used = 0
    for i in ranked:
        if used + i.bytes_per_layer <= budget_bytes_per_layer:
            saved.append(i.name)
            used += i.bytes_per_layer
    return saved


def _keep_set(intermediates: Sequence[Intermediate],
              budget_bytes_per_layer: int,
              evict_s: Dict[str, float]) -> List[str]:
    """Keep set maximising evicted-cost-avoided under the byte budget.

    Keeping an intermediate avoids exactly its cheapest eviction price, so
    the optimal keep set is a 0/1 knapsack with value ``evict_s`` and weight
    ``bytes_per_layer`` — solved exactly for the small per-block tag sets
    (ties prefer more kept bytes: fewer evictions to account for), greedily
    by cost density for larger universes.
    """
    items = list(intermediates)
    if len(items) <= _EXACT_KNAPSACK_MAX_ITEMS:
        best_mask, best_value, best_bytes = 0, -1.0, -1
        for mask in range(1 << len(items)):
            used = value = 0
            for bit, i in enumerate(items):
                if mask >> bit & 1:
                    used += i.bytes_per_layer
                    value += evict_s[i.name]
            if used > budget_bytes_per_layer:
                continue
            if value > best_value or (value == best_value and used > best_bytes):
                best_mask, best_value, best_bytes = mask, value, used
        return [i.name for bit, i in enumerate(items) if best_mask >> bit & 1]
    return _greedy_keep_set(items, budget_bytes_per_layer, evict_s)


def plan_joint_policy(
    intermediates: Sequence[Intermediate],
    budget_bytes_per_layer: Optional[int],
    *,
    offload: bool = True,
    dma_gbps: Optional[float] = None,
    device_tflops: Optional[float] = None,
) -> RematPlan:
    """Jointly choose keep / recompute / offload per intermediate.

    Minimises the estimated per-layer step-time cost (recompute FLOPs at
    ``device_tflops`` vs DMA round trips at ``dma_gbps``) subject to the
    per-layer HBM budget.  ``budget_bytes_per_layer`` of None means "save
    everything" (keeping is free at step time, so with no budget pressure
    nothing is ever evicted); 0 means every intermediate is evicted down
    its cheaper lane.  ``offload=False`` disables the offload lane (pure
    save-vs-recompute — the classic remat knapsack).  ``dma_gbps`` of
    ``math.inf`` prices DMA as free (with the traffic still accounted).
    """
    dma_gbps = DEFAULT_DMA_GBPS if dma_gbps is None else dma_gbps
    device_tflops = DEFAULT_DEVICE_TFLOPS if device_tflops is None \
        else device_tflops

    cost: Dict[str, float] = {}
    lane: Dict[str, str] = {}
    for i in intermediates:
        cost[i.name], lane[i.name] = _evict_cost_s(
            i, offload=offload, dma_gbps=dma_gbps,
            device_tflops=device_tflops)

    if budget_bytes_per_layer is None:
        saved = [i.name for i in intermediates]
    elif offload and math.isinf(dma_gbps):
        # deprecated free-DMA mode: every avoided cost is zero, so the
        # knapsack is degenerate — use the historical greedy flops-per-byte
        # fill so the alias reproduces its old keep/offload sets exactly
        saved = _greedy_keep_set(intermediates, budget_bytes_per_layer, cost)
    else:
        saved = _keep_set(intermediates, budget_bytes_per_layer, cost)

    saved_set = set(saved)
    by_name = {i.name: i for i in intermediates}
    dropped = tuple(i.name for i in intermediates
                    if i.name not in saved_set and lane[i.name] == RECOMPUTE)
    offloaded = tuple(i.name for i in intermediates
                      if i.name not in saved_set and lane[i.name] == OFFLOAD)
    return RematPlan(
        saved=tuple(i.name for i in intermediates if i.name in saved_set),
        dropped=dropped,
        saved_bytes_per_layer=sum(
            by_name[n].bytes_per_layer for n in saved_set),
        recompute_flops_per_layer=sum(
            by_name[n].recompute_flops for n in dropped),
        offloaded=offloaded,
        offload_dma_bytes_per_layer=sum(
            2 * by_name[n].bytes_per_layer for n in offloaded),
        est_step_time_s_per_layer=sum(
            cost[n] for n in dropped + offloaded),
    )


def plan_step_time_s(plan: RematPlan, intermediates: Sequence[Intermediate],
                     *, dma_gbps: Optional[float] = None,
                     device_tflops: Optional[float] = None) -> float:
    """Re-price a plan's decisions under a given hardware cost model.

    The honest per-layer step-time estimate of *any* RematPlan — including
    plans made under the deprecated free-DMA pricing — so alternatives can
    be compared on equal terms (the joint-optimality acceptance check).
    """
    dma_gbps = DEFAULT_DMA_GBPS if dma_gbps is None else dma_gbps
    device_tflops = DEFAULT_DEVICE_TFLOPS if device_tflops is None \
        else device_tflops
    by_name = {i.name: i for i in intermediates}
    total = 0.0
    for n in plan.dropped:
        total += _lane_costs_s(by_name[n], dma_gbps, device_tflops)[0]
    for n in plan.offloaded:
        total += _lane_costs_s(by_name[n], dma_gbps, device_tflops)[1]
    return total


def tag(name: str, x):
    """Tag an intermediate for the checkpoint policy (the identity outside
    a checkpointed block; see :mod:`repro_torch.core.remat`)."""
    from repro_torch.core import remat   # torch; this module stays pure
    return remat.tag(name, x)


# ---------------------------------------------------------------------------
# Standard transformer intermediates, parameterised by the block shape.
# ---------------------------------------------------------------------------

def transformer_intermediates(*, batch_tokens: int, d_model: int, d_ff: int,
                              n_q_heads: int, n_kv_heads: int, head_dim: int,
                              moe_experts_per_token: int = 0,
                              dtype_bytes: int = 2) -> List[Intermediate]:
    """Byte/FLOP cost model for one decoder block at the given token count."""
    bt = batch_tokens
    qkv_bytes = bt * (n_q_heads + 2 * n_kv_heads) * head_dim * dtype_bytes
    qkv_flops = 2 * bt * d_model * (n_q_heads + 2 * n_kv_heads) * head_dim
    attn_out_bytes = bt * d_model * dtype_bytes
    # attention recompute ~ 2 * seq * heads * head_dim per token (flash bwd
    # recomputes scores anyway; keeping attn_out avoids the output proj only)
    attn_out_flops = 2 * bt * d_model * d_model
    hidden_mult = max(moe_experts_per_token, 1)
    mlp_hidden_bytes = bt * d_ff * hidden_mult * dtype_bytes * 2  # gate+up
    mlp_hidden_flops = 2 * bt * d_model * d_ff * hidden_mult * 2
    mlp_out_bytes = bt * d_model * dtype_bytes
    mlp_out_flops = 2 * bt * d_ff * hidden_mult * d_model
    return [
        Intermediate("qkv", qkv_bytes, qkv_flops),
        Intermediate("attn_out", attn_out_bytes, attn_out_flops),
        Intermediate("mlp_hidden", mlp_hidden_bytes, mlp_hidden_flops),
        Intermediate("mlp_out", mlp_out_bytes, mlp_out_flops),
    ]
