"""Plain float32 PyTorch that the families share: norms, rotary attention,
SwiGLU, the loss, AdamW, and the loop that follows a train step's first
steps.

Nothing here imports the program or JAX: this is the benchmark's own
statement of the mathematics the program is held to.  Each layer is the
published formula in float32 with no kernel and no cache; the weight
products go through a :class:`Matmul` of a stated precision, float32 for
the reference and float8 (e4m3) for the control, which stands for the step
down from the bfloat16 the configurations compute in.  Blocks run under
``torch.utils.checkpoint`` so that a reference at the timed sizes fits on
the card beside nothing else.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]

E4M3_MAX = 448.0


def _fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one absmax scale for the tensor,
    held in float32; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


class Matmul:
    """``x @ w`` for the weight products, in ``precision``: "float32" (the
    reference), or "float8" (the control: both operands rounded to e4m3,
    the products summed in float32, as an fp8 tensor-core GEMM does)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "float8":
            return _fake_fp8(x) @ _fake_fp8(w)
        return x @ w


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions 0..S-1, the two halves of D
    paired (rotate-half)."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(cfg: Dict, p: Params, pre: str, x: torch.Tensor,
              mm: Matmul) -> torch.Tensor:
    """Causal grouped-query self-attention with rotary q and k: query head
    j reads key/value head j // (heads / kv heads)."""
    b, s, _ = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = rope(mm(x, p[pre + "wq"]).view(b, s, h, hd), cfg["rope_theta"])
    k = rope(mm(x, p[pre + "wk"]).view(b, s, kv, hd), cfg["rope_theta"])
    v = mm(x, p[pre + "wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    o = torch.stack([ckpt(_causal_softmax_pv, q[i], k[i], v[i])
                     for i in range(b)])
    return mm(o.reshape(b, s, h * hd), p[pre + "wo"])


def _causal_softmax_pv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    """One sequence's causal softmax(q kᵀ / sqrt(D)) v, q k v (S, H, D):
    a sequence at a time, so that the (H, S, S) scores of one sequence
    are all the card holds of them."""
    s, hd = q.shape[0], q.shape[-1]
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    above = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(above, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", probs, v)


def swiglu(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    return mm(silu(mm(x, gate)) * mm(x, up), down)


def padded_vocab(cfg: Dict) -> int:
    pad = cfg["vocab_pad"]
    return -(-cfg["vocab"] // pad) * pad


def xent(logits: torch.Tensor, targets: torch.Tensor, vocab: int
         ) -> torch.Tensor:
    """Mean next-token cross-entropy over the first ``vocab`` columns (the
    rest are padding: no token is ever there)."""
    lf = logits[..., :vocab]
    return F.cross_entropy(lf.reshape(-1, vocab), targets.reshape(-1).long())


def output_xent(h: torch.Tensor, w_out: torch.Tensor, targets: torch.Tensor,
                vocab: int, mm: Matmul) -> torch.Tensor:
    """The mean cross-entropy of ``mm(h, w_out)`` (h (B, S, d)), one
    sequence's logits at a time: every sequence has S tokens, so the mean
    of the sequences' means is the mean over all tokens."""
    parts = [ckpt(lambda hi, ti: xent(mm(hi, w_out), ti, vocab),
                  h[i], targets[i]) for i in range(h.shape[0])]
    return torch.stack(parts).mean()


def ckpt(fn: Callable, *args):
    """``fn(*args)``, its activations rebuilt in the backward."""
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# AdamW and the loop
# ---------------------------------------------------------------------------

def adamw_step_(params: Params, state: Dict, hp: Dict) -> None:
    """One decoupled-weight-decay Adam step in place, leaf by leaf: each
    parameter's ``.grad`` is the step's gradient.  Bias corrections from
    the step count; the decay applies to every parameter."""
    state["count"] += 1
    t = state["count"]
    b1, b2 = hp["b1"], hp["b2"]
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    with torch.no_grad():
        for n, p in params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / c1) / (torch.sqrt(v / c2) + hp["eps"])
            p.sub_(hp["lr"] * (upd + hp["weight_decay"] * p))
            p.grad = None


def follow(loss_fn: Callable, cfg: Dict, params: Params,
           batches: Sequence[Dict[str, torch.Tensor]], microbatches: int,
           hp: Dict, mm: Matmul) -> Dict:
    """Train ``params`` in place through ``batches``, one step each: the
    batch split along its rows into ``microbatches`` equal parts, each
    part's mean loss back-propagated, the gradients summed and divided by
    ``microbatches`` (the step's gradient), then AdamW.  Returns each
    step's loss (the mean of its parts) and the first step's gradient norm
    of every parameter."""
    for p in params.values():
        p.requires_grad_(True)
    state = {"count": 0,
             "m": {n: torch.zeros_like(p) for n, p in params.items()},
             "v": {n: torch.zeros_like(p) for n, p in params.items()}}
    losses: List[float] = []
    first: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        total = 0.0
        parts = [{k: v.chunk(microbatches)[i] for k, v in batch.items()}
                 for i in range(microbatches)]
        for part in parts:
            loss = loss_fn(cfg, params, part["tokens"], part["targets"], mm)
            loss.backward()
            total += float(loss.detach())
            del loss
        with torch.no_grad():
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(microbatches)
            if step == 0:
                first = {n: 0.0 if p.grad is None
                         else float(torch.linalg.vector_norm(p.grad))
                         for n, p in params.items()}
        adamw_step_(params, state, hp)
        losses.append(total / microbatches)
    del state
    for p in params.values():
        p.requires_grad_(False)
    return {"losses": losses, "first_grad_norms": first}
