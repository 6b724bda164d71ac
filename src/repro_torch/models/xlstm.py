"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelisable)
and sLSTM (scalar memory, sequential).

Port of ``repro/models/xlstm.py``.  The mLSTM forward calls the port's
``mlstm_scan`` (the sm_90a mLSTM chunk kernel for CUDA tensors, its plain
twin on the CPU) where the reference calls the jnp ``mlstm_chunked``: the
same stabilised chunkwise function at the same chunk of 256.
:func:`mlstm_chunked` is the port of that jnp function; ``mlstm_scan``'s
backward is its vjp, recomputed from the saved inputs.  Decode keeps
the matrix memory C: (B, H, P, P), the normaliser n: (B, H, P) and the
stabiliser m: (B, H).  The projections are full ``di x di`` matrices, as in
the reference (not the paper's block-diagonal ones).

sLSTM keeps per-unit scalar state with a true recurrent dependency (h feeds
the next step's gates), so its prefill is a Python loop over time, as the
reference's ``lax.scan``; the reference has no kernel for it.

Parameters are a dict per block (held by ``transformer.MLSTMBlock`` and
``transformer.SLSTMBlock``): dense kernels in the compute dtype to serve
and in ``param_dtype`` (float32) to train; the gate
projection ``w_if``, its bias ``b_if``, the sLSTM ``bias`` and the norm
scales in float32 (the reference casts ``bias`` to the compute dtype at
use).  The reference's cost-probe ``mixer_skip`` mode (``launch/probe.py``)
bypasses the mLSTM scan: y = q + v in float32, and no kernel is launched.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat_policy import tag
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.models import layers

Tree = Dict[str, torch.Tensor]


def _widths(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(di, heads h, head dim p): the up-projection factor is 2."""
    di = 2 * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig, *,
               trainable: bool = False) -> Tree:
    dt = layers.weight_dtype(cfg, trainable)
    d = cfg.d_model
    di, h, _ = _widths(cfg)
    dev = gen.device
    return {
        "up_l": layers.dense_init(gen, d, di, dtype=dt),     # gated branch
        "up_r": layers.dense_init(gen, d, di, dtype=dt),     # skip branch
        "wq": layers.dense_init(gen, di, di, dtype=dt),
        "wk": layers.dense_init(gen, di, di, dtype=dt),
        "wv": layers.dense_init(gen, di, di, dtype=dt),
        "w_if": torch.randn(di, 2 * h, generator=gen, device=dev) * 0.01,
        "b_if": torch.cat([torch.zeros(h, device=dev),
                           torch.full((h,), 3.0, device=dev)]),
        "norm": layers.rmsnorm_init(di, device=dev),
        "down": layers.dense_init(gen, di, d, dtype=dt),
    }


def mlstm_specs():
    return {"up_l": layers.dense_specs("embed", "mlp"),
            "up_r": layers.dense_specs("embed", "mlp"),
            "wq": layers.dense_specs("mlp", "mlp"),
            "wk": layers.dense_specs("mlp", "mlp"),
            "wv": layers.dense_specs("mlp", "mlp"),
            "w_if": ("mlp", None),
            "b_if": (None,),
            "norm": ("mlp",),
            "down": layers.dense_specs("mlp", "embed")}


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                  chunk: int = 256) -> torch.Tensor:
    """Stabilised chunkwise mLSTM, the reference's jnp ``mlstm_chunked`` in
    PyTorch ops: q, k, v (b, s, h, p); i_gate, f_gate (b, s, h) raw
    logits -> (b, s, h, p).  ``mlstm_scan``'s backward is its vjp.

    Written as the reference is (-inf above the diagonal, the cross-chunk
    recurrence a loop as its ``lax.scan``), so autograd through it gives
    the reference's gradient: the row maxima are ``amax``, which splits
    the gradient between tied entries as JAX's ``reduce_max`` does, and
    each three-operand einsum is two products with k met by its decay
    first, so no (t, p, r) tensor is formed (at p = 1024 and 256-row
    chunks k x v alone would be 17 GB)."""
    b, s, h, p = q.shape
    scale = 1.0 / math.sqrt(p)
    lf = layers.log_sigmoid(f_gate)                      # (b,s,h) log f
    li = i_gate                                          # log input gate
    qc = min(chunk, s)
    nc = -(-s // qc)
    pad = nc * qc - s
    if pad:
        pad4 = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(t, pad4) for t in (q, k, v))
        lf = torch.nn.functional.pad(lf, (0, 0, 0, pad))
        li = torch.nn.functional.pad(li, (0, 0, 0, pad), value=-1e30)

    qb = q.reshape(b, nc, qc, h, p) * scale
    kb = k.reshape(b, nc, qc, h, p)
    vb = v.reshape(b, nc, qc, h, p)
    lfb = lf.reshape(b, nc, qc, h)
    lib = li.reshape(b, nc, qc, h)

    lf_cum = layers.cumsum(lfb, 2)                       # within-chunk
    # D[q, t] = sum_{t<j<=q} lf_j + li_t for t <= q
    seg = lf_cum[:, :, :, None, :] - lf_cum[:, :, None, :, :]  # b,c,q,t,h
    upper = torch.ones(qc, qc, dtype=torch.bool, device=q.device).triu(1)
    dmat = (seg + lib[:, :, None, :, :]).masked_fill(
        upper[None, None, :, :, None], float("-inf"))
    m_intra = dmat.amax(dim=3)                           # (b,nc,q,h)
    scores = torch.einsum("bcqhp,bcthp->bcqth", qb, kb)

    # ---- chunk summary state ---------------------------------------------
    decay_to_end = lf_cum[:, :, -1:, :] - lf_cum + lib   # (b,nc,q,h)
    m_state = decay_to_end.amax(dim=2)                   # (b,nc,h)
    sk = torch.exp(decay_to_end - m_state[:, :, None, :])
    ks = kb * sk[..., None]                              # k by its decay
    states = torch.einsum("bcthp,bcthr->bchpr", ks, vb)  # (b,nc,h,p,p)
    norms = ks.sum(dim=2)                                # (b,nc,h,p)
    chunk_lf = lf_cum[:, :, -1, :]                       # (b,nc,h)

    # ---- inter-chunk recurrence (log-stabilised) ---------------------------
    C = torch.zeros(b, h, p, p, dtype=q.dtype, device=q.device)
    n = torch.zeros(b, h, p, dtype=q.dtype, device=q.device)
    m = torch.full((b, h), -1e30, dtype=q.dtype, device=q.device)
    C_prev, n_prev, m_prev = [], [], []
    for c in range(nc):
        C_prev.append(C)                                 # emit previous
        n_prev.append(n)
        m_prev.append(m)
        m_new = torch.maximum(m + chunk_lf[:, c], m_state[:, c])
        alpha = torch.exp(m + chunk_lf[:, c] - m_new)
        beta = torch.exp(m_state[:, c] - m_new)
        C = C * alpha[..., None, None] + states[:, c] * beta[..., None, None]
        n = n * alpha[..., None] + norms[:, c] * beta[..., None]
        m = m_new
    C_prev = torch.stack(C_prev, dim=1)
    n_prev = torch.stack(n_prev, dim=1)
    m_prev = torch.stack(m_prev, dim=1)

    # ---- combine intra + inter --------------------------------------------
    inter_decay = lf_cum + m_prev[:, :, None, :]         # (b,nc,q,h)
    m_total = torch.maximum(m_intra, inter_decay)
    w_intra = torch.exp(dmat - m_total[:, :, :, None, :])  # (b,nc,q,t,h)
    w_inter = torch.exp(inter_decay - m_total)           # (b,nc,q,h)

    sw = scores * w_intra
    y_intra = torch.einsum("bcqth,bcthr->bcqhr", sw, vb)
    qw = qb * w_inter[..., None]
    y_inter = torch.einsum("bcqhp,bchpr->bcqhr", qw, C_prev)
    n_intra = sw.sum(dim=3)
    n_inter = torch.einsum("bcqhp,bchp->bcqh", qw, n_prev)
    y = (y_intra + y_inter) / _normaliser(n_intra + n_inter,
                                          m_total)[..., None]
    return y.reshape(b, nc * qc, h, p)[:, :s]


def _normaliser(n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """max(|n|, exp(-m)), the stabilised normaliser: a kink where the two
    nearly tie, so there the gradient depends on which side the float32
    rounding of n and m falls."""
    return torch.maximum(torch.abs(n), torch.exp(-m))


def _gates(params, xl: torch.Tensor):
    """(input gate, forget gate) logits in float32, as the reference's
    ``xl.astype(f32) @ w_if + b_if``."""
    gates = xl.float() @ params["w_if"] + params["b_if"]
    return gates.chunk(2, dim=-1)


def mlstm_forward(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Prefill path."""
    dt = layers.dtype_of(cfg.dtype)
    b, s, _ = x.shape
    di, h, p = _widths(cfg)
    xl = layers.dense(params["up_l"], x, dt)
    xr = layers.dense(params["up_r"], x, dt)
    q = layers.dense(params["wq"], xl, dt).reshape(b, s, h, p)
    k = layers.dense(params["wk"], xl, dt).reshape(b, s, h, p)
    v = layers.dense(params["wv"], xl, dt).reshape(b, s, h, p)
    q = tag("qkv", q)
    i_gate, f_gate = _gates(params, xl)                  # (b,s,h) each
    if cfg.mixer_skip:
        # cost-probe mode: the mLSTM kernel's cost is added analytically
        # (launch/costs.py)
        y = (q + v).float()
    else:
        y = mlstm_scan(q.float(), k.float(), v.float(), i_gate, f_gate)
    y = tag("attn_out", y.reshape(b, s, di).to(dt))
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * layers.silu(xr)
    return layers.dense(params["down"], y, dt)


def init_mlstm_state(cfg: ModelConfig, batch: int, n_layers: int, *, device
                     ) -> Dict[str, torch.Tensor]:
    _, h, p = _widths(cfg)
    return {
        "C": torch.zeros(n_layers, batch, h, p, p, device=device),
        "n": torch.zeros(n_layers, batch, h, p, device=device),
        "m": torch.full((n_layers, batch, h), -1e30, device=device),
    }


def mlstm_decode_step(cfg: ModelConfig, params, x: torch.Tensor,
                      C: torch.Tensor, n: torch.Tensor, m: torch.Tensor):
    """O(1) mLSTM decode.  x: (B,1,d); C: (B,H,P,P); n: (B,H,P); m: (B,H).
    Returns (y, C, n, m), the state as new tensors."""
    dt = layers.dtype_of(cfg.dtype)
    b = x.shape[0]
    di, h, p = _widths(cfg)
    xl = layers.dense(params["up_l"], x, dt)[:, 0]
    xr = layers.dense(params["up_r"], x, dt)[:, 0]
    # the reference scales q in the compute dtype: its weak-typed Python
    # scale is first rounded to that dtype
    scale = torch.tensor(1.0 / math.sqrt(p), dtype=dt).item()
    q = layers.dense(params["wq"], xl[:, None], dt).reshape(b, h, p) * scale
    k = layers.dense(params["wk"], xl[:, None], dt).reshape(b, h, p)
    v = layers.dense(params["wv"], xl[:, None], dt).reshape(b, h, p)
    li, fg = _gates(params, xl)                          # (b,h)
    lf = layers.log_sigmoid(fg)
    m_new = torch.maximum(lf + m, li)
    alpha = torch.exp(lf + m - m_new)
    beta = torch.exp(li - m_new)
    kf, vf = k.float(), v.float()
    C_new = C * alpha[..., None, None] + beta[..., None, None] \
        * torch.einsum("bhp,bhr->bhpr", kf, vf)
    n_new = n * alpha[..., None] + beta[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhp,bhpr->bhr", qf, C_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, di).to(dt)
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps)
    y = y * layers.silu(xr[:, None])
    return layers.dense(params["down"], y, dt), C_new, n_new, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig, *,
               trainable: bool = False) -> Tree:
    dt = layers.weight_dtype(cfg, trainable)
    d = cfg.d_model
    return {
        "wx": layers.dense_init(gen, d, 4 * d, dtype=dt),
        "wh": layers.dense_init(gen, d, 4 * d, dtype=dt),
        "bias": torch.zeros(4 * d, device=gen.device),
        "norm": layers.rmsnorm_init(d, device=gen.device),
        "proj": layers.dense_init(gen, d, d, dtype=dt),
    }


def slstm_specs():
    return {"wx": layers.dense_specs("embed", "mlp"),
            "wh": layers.dense_specs("embed", "mlp"),
            "bias": ("mlp",),
            "norm": ("embed",),
            "proj": layers.dense_specs("embed", "embed")}


def _slstm_cell(g: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor):
    """One stabilised sLSTM step on float32 gate logits g: (B, 4d).
    Returns (h, c, n, m), h in float32."""
    zi, zf, zo, zz = g.chunk(4, dim=-1)
    lf = layers.log_sigmoid(zf)
    m_new = torch.maximum(lf + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(lf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h_new = torch.sigmoid(zo) * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, c_new, n_new, m_new


def slstm_forward(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Sequential loop over time (true recurrence: h feeds the next gates).
    The carried h is rounded to the compute dtype, as the reference's.
    ``wh`` is cast to the compute dtype once, before the loop: a float32
    (trainable) ``wh`` cast at every step would leave one copy per step
    among the residuals autograd saves."""
    dt = layers.dtype_of(cfg.dtype)
    b, s, d = x.shape
    gx = layers.dense(params["wx"], x, dt) + params["bias"].to(dt)
    wh = params["wh"].to(dt)
    h = torch.zeros(b, d, dtype=dt, device=x.device)
    c = torch.zeros(b, d, device=x.device)
    n = torch.zeros(b, d, device=x.device)
    m = torch.full((b, d), -1e30, device=x.device)
    ys = torch.empty(b, s, d, dtype=dt, device=x.device)
    for t in range(s):
        g = gx[:, t] + layers.dense(wh, h, dt)
        h, c, n, m = _slstm_cell(g.float(), c, n, m)
        h = h.to(dt)
        ys[:, t] = h
    y = layers.rmsnorm(params["norm"], ys, cfg.norm_eps)
    return layers.dense(params["proj"], y, dt)


def init_slstm_state(cfg: ModelConfig, batch: int, n_layers: int, *, device
                     ) -> Dict[str, torch.Tensor]:
    """float32 state; h is cast to the compute dtype where it is used."""
    shape = (n_layers, batch, cfg.d_model)
    return {"h": torch.zeros(shape, device=device),
            "c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, -1e30, device=device)}


def slstm_decode_step(cfg: ModelConfig, params, x: torch.Tensor,
                      h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                      m: torch.Tensor):
    """x: (B,1,d); h, c, n, m: (B, d) float32.  Returns (y, h, c, n, m)."""
    dt = layers.dtype_of(cfg.dtype)
    g = layers.dense(params["wx"], x, dt)[:, 0] + params["bias"].to(dt) \
        + layers.dense(params["wh"], h.to(dt), dt)
    h_new, c_new, n_new, m_new = _slstm_cell(g.float(), c, n, m)
    y = layers.rmsnorm(params["norm"], h_new[:, None].to(dt), cfg.norm_eps)
    return layers.dense(params["proj"], y, dt), h_new, c_new, n_new, m_new
