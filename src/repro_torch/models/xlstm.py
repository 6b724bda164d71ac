"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelisable)
and sLSTM (scalar memory, sequential).

Port of ``repro/models/xlstm.py``.  The mLSTM prefill path calls the port's
``mlstm_scan`` (the sm_90a mLSTM chunk kernel for CUDA tensors, its plain
twin on the CPU) where the reference calls the jnp ``mlstm_chunked``: the
same stabilised chunkwise function at the same chunk of 256.  Decode keeps
the matrix memory C: (B, H, P, P), the normaliser n: (B, H, P) and the
stabiliser m: (B, H).  The projections are full ``di x di`` matrices, as in
the reference (not the paper's block-diagonal ones).

sLSTM keeps per-unit scalar state with a true recurrent dependency (h feeds
the next step's gates), so its prefill is a Python loop over time, as the
reference's ``lax.scan``; the reference has no kernel for it.

Parameters are a dict per block (held by ``transformer.MLSTMBlock`` and
``transformer.SLSTMBlock``): dense kernels in the compute dtype; the gate
projection ``w_if``, its bias ``b_if``, the sLSTM ``bias`` and the norm
scales in float32 (the reference casts ``bias`` to the compute dtype at
use).  The reference's cost-probe ``mixer_skip`` mode is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
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

def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    dt = layers.dtype_of(cfg.dtype)
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


def _gates(params, xl: torch.Tensor):
    """(input gate, forget gate) logits in float32, as the reference's
    ``xl.astype(f32) @ w_if + b_if``."""
    gates = xl.float() @ params["w_if"] + params["b_if"]
    return gates.chunk(2, dim=-1)


def mlstm_forward(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Prefill path."""
    if cfg.mixer_skip:
        # the reference's cost-probe mode (launch/probe.py)
        raise NotImplementedError("mixer_skip is not ported")
    dt = layers.dtype_of(cfg.dtype)
    b, s, _ = x.shape
    di, h, p = _widths(cfg)
    xl = layers.dense(params["up_l"], x, dt)
    xr = layers.dense(params["up_r"], x, dt)
    q = layers.dense(params["wq"], xl, dt).reshape(b, s, h, p)
    k = layers.dense(params["wk"], xl, dt).reshape(b, s, h, p)
    v = layers.dense(params["wv"], xl, dt).reshape(b, s, h, p)
    i_gate, f_gate = _gates(params, xl)                  # (b,s,h) each
    y = mlstm_scan(q.float(), k.float(), v.float(), i_gate, f_gate)
    y = y.reshape(b, s, di).to(dt)
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

def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> Tree:
    dt = layers.dtype_of(cfg.dtype)
    d = cfg.d_model
    return {
        "wx": layers.dense_init(gen, d, 4 * d, dtype=dt),
        "wh": layers.dense_init(gen, d, 4 * d, dtype=dt),
        "bias": torch.zeros(4 * d, device=gen.device),
        "norm": layers.rmsnorm_init(d, device=gen.device),
        "proj": layers.dense_init(gen, d, d, dtype=dt),
    }


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
    The carried h is rounded to the compute dtype, as the reference's."""
    dt = layers.dtype_of(cfg.dtype)
    b, s, d = x.shape
    gx = layers.dense(params["wx"], x, dt) + params["bias"].to(dt)
    h = torch.zeros(b, d, dtype=dt, device=x.device)
    c = torch.zeros(b, d, device=x.device)
    n = torch.zeros(b, d, device=x.device)
    m = torch.full((b, d), -1e30, device=x.device)
    ys = torch.empty(b, s, d, dtype=dt, device=x.device)
    for t in range(s):
        g = gx[:, t] + layers.dense(params["wh"], h, dt)
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
