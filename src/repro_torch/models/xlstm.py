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

Under a mesh whose ``model`` axis has more than one rank, each rank runs
the mLSTM on its own block of the heads (:func:`rank_heads`).  The
placement gives it column blocks of ``up_l`` and ``up_r`` (its heads'
``di`` columns exactly) but row blocks of the square ``wq``, ``wk`` and
``wv`` (the reference's ``("mlp", "mlp")`` specs give ``model`` to the
first dim only): a rank's ``xl`` block times its row block is a partial
product over all of ``di``, and a reduce-scatter over ``model``
(``collectives.sum_scatter``, an all-gather backward) keeps its heads'
columns of the sum, 3 x B x S x di values of the compute dtype a layer
where gathering the weights would move 3 x di^2.  The gate logits are
the sum of the row blocks' products over ``model``
(``collectives.shared_sum``), ``b_if`` added after it; each rank reads
its heads' (i, f) columns, so ``b_if``'s gradient is partial
(:func:`mlstm_specs`).  The norm's variance runs over all of ``di``
(``layers.rmsnorm(ways=)``) and ``down``'s row block gives a partial
output summed over ``model``.  The sLSTM recurrence runs whole on every
rank: ``wx``, ``wh`` and ``bias`` are gathered over ``model`` once,
before the loop (``collectives.gather_whole``, whose backward hands each
rank its block of the gradient every rank holds whole), so no step of the
loop makes a collective.  Every weight is read through
``collectives.fetch`` (FSDP shards gathered).  Without such a mesh each
of these steps is the identity and the blocks are the reference's.

At decode the state keeps the reference's placement: the mLSTM memory
``C`` splits its value dim over ``model`` (``mlstm_state_specs``), so
each rank sums q, k and v over ``model`` (B x 3 di values), updates its
value columns of ``C`` (``n`` and ``m`` whole), and all-gathers its
columns of y; the sLSTM state is replicated and its step runs whole.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat_policy import tag
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.models import layers
from repro_torch.sharding import api
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R

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
    """The reference's.  Where the ranks split the heads
    (:func:`rank_heads`), each reads only its heads' entries of the
    replicated ``b_if``, so its gradient is partial over ``model``."""
    return api.SplitSpecs({"up_l": layers.dense_specs("embed", "mlp"),
                           "up_r": layers.dense_specs("embed", "mlp"),
                           "wq": layers.dense_specs("mlp", "mlp"),
                           "wk": layers.dense_specs("mlp", "mlp"),
                           "wv": layers.dense_specs("mlp", "mlp"),
                           "w_if": ("mlp", None),
                           "b_if": (None,),
                           "norm": ("mlp",),
                           "down": layers.dense_specs("mlp", "embed")},
                          lambda cfg, shardings: ("b_if",)
                          if rank_heads(cfg)[1] < cfg.n_heads else ())


def mlstm_state_specs():
    """The decode state's logical axes (the reference's): ``C``'s value
    dim over ``state``."""
    return {"C": (None, "batch", None, "sp_seq", "state"),
            "n": (None, "batch", None, "sp_seq"),
            "m": (None, "batch", None)}


def slstm_state_specs():
    return {k: (None, "batch", None) for k in ("h", "c", "n", "m")}


def rank_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(first head, heads) of the mLSTM heads this rank computes: all of
    them without a mesh or on a ``model`` axis of one rank, else its block
    of them."""
    mesh = R.current_mesh()
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    h = cfg.n_heads
    if h % m:
        raise NotImplementedError(
            f"{cfg.name}: {h} mLSTM heads do not split over a model axis of "
            f"{m} ranks (ROADMAP item 11: only whole heads a rank are run)")
    return (mesh.coords()["model"] * (h // m) if m > 1 else 0), h // m


_SPLIT_DIMS = (("up_l", 1), ("up_r", 1), ("wq", 0), ("wk", 0), ("wv", 0),
               ("w_if", 0), ("norm", 0), ("down", 0))


def _check_split(cfg: ModelConfig, params) -> None:
    for name, dim in _SPLIT_DIMS:
        if not C.split_over(params[name], dim):
            raise NotImplementedError(
                f"{cfg.name}: {name}'s placement does not split its mlp "
                "dim over the model axis (ROADMAP item 11)")


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


def _gates(cfg: ModelConfig, params, xl: torch.Tensor, h0: int, hl: int):
    """(input gate, forget gate) logits in float32 of heads ``h0`` to
    ``h0 + hl``, as the reference's ``xl.astype(f32) @ w_if + b_if``: under
    a mesh ``xl`` is this rank's block of columns and ``w_if`` its row
    block, whose products are summed over ``model`` before the bias."""
    gates = C.shared_sum(xl.float() @ C.fetch(params["w_if"]), "model") \
        + C.fetch(params["b_if"])
    h = cfg.n_heads
    return gates[..., h0:h0 + hl], gates[..., h + h0:h + h0 + hl]


def mlstm_forward(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Prefill path.  Under a mesh that splits
    the heads (:func:`rank_heads`), the block on this rank's heads, its
    partial output summed over ``model``."""
    dt = layers.dtype_of(cfg.dtype)
    b, s, _ = x.shape
    di, h, p = _widths(cfg)
    h0, hl = rank_heads(cfg)
    if hl < h:
        _check_split(cfg, params)
    x = C.copy_to(x)
    xl = layers.dense(C.fetch(params["up_l"]), x, dt)   # the rank's heads'
    xr = layers.dense(C.fetch(params["up_r"]), x, dt)   # di columns

    def project(name):
        # a row block's partial product over all of di: the rank keeps its
        # heads' columns of the sum
        part = layers.dense(C.fetch(params[name]), xl, dt)
        return C.sum_scatter(part, "model", 2).reshape(b, s, hl, p)

    q, k, v = project("wq"), project("wk"), project("wv")
    q = tag("qkv", q)
    i_gate, f_gate = _gates(cfg, params, xl, h0, hl)    # (b,s,hl) each
    if cfg.mixer_skip:
        # cost-probe mode: the mLSTM kernel's cost is added analytically
        # (launch/costs.py)
        y = (q + v).float()
    else:
        y = mlstm_scan(q.float(), k.float(), v.float(), i_gate, f_gate)
    y = tag("attn_out", y.reshape(b, s, hl * p).to(dt))
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps, ways=h // hl)
    y = y * layers.silu(xr)
    return C.reduce_from(layers.dense(C.fetch(params["down"]), y, dt))


def init_mlstm_state(cfg: ModelConfig, batch: int, n_layers: int, *, device
                     ) -> Dict[str, torch.Tensor]:
    _, h, p = _widths(cfg)
    return {
        "C": torch.zeros(n_layers, batch, h, p, p, device=device),
        "n": torch.zeros(n_layers, batch, h, p, device=device),
        "m": torch.full((n_layers, batch, h), -1e30, device=device),
    }


def mlstm_decode_step(cfg: ModelConfig, params, x: torch.Tensor,
                      C_: torch.Tensor, n: torch.Tensor, m: torch.Tensor):
    """O(1) mLSTM decode.  x: (B,1,d); C_: (B,H,P,P); n: (B,H,P); m: (B,H).
    Returns (y, C, n, m), the state as new tensors.

    Under a mesh ``C_`` is this rank's block of the value dim (B, H, P,
    P / ranks) over ``model``: q, k and v are summed over ``model`` from
    the row blocks' partial products, the rank updates its value columns
    of C, forms its columns of y and all-gathers them.  Where the rules
    put the key dim over ``data`` too (``sp_seq``: a batch that does not
    split), ``C_`` holds key rows ``[k0, k0 + pk)`` and ``n`` the same
    block of its entries: the rank updates them with its slice of k, and
    its partial ``q . C`` and ``q . n`` are summed over ``data`` (one
    all-reduce) before the normaliser's ``abs`` and ``max``.  ``m`` is
    whole, the same on every rank."""
    dt = layers.dtype_of(cfg.dtype)
    b = x.shape[0]
    di, h, p = _widths(cfg)
    h0, hl = rank_heads(cfg)
    if hl < h:
        _check_split(cfg, params)
    pk, pl = C_.shape[-2:]                  # this rank's key rows, columns
    k0 = C.block_start_of(pk, p, "data")
    r0 = C.block_start_of(pl, p, "model")
    xl = layers.dense(C.fetch(params["up_l"]), x, dt)[:, 0]
    xr = layers.dense(C.fetch(params["up_r"]), x, dt)[:, 0]
    # the reference scales q in the compute dtype: its weak-typed Python
    # scale is first rounded to that dtype
    scale = torch.tensor(1.0 / math.sqrt(p), dtype=dt).item()
    qkv = torch.cat([layers.dense(C.fetch(params[w]), xl, dt)
                     for w in ("wq", "wk", "wv")], dim=-1)
    if hl < h:
        # the row blocks' partial q, k and v summed in one call
        qkv = C.all_reduce(qkv, "model")
    q, k, v = (t.reshape(b, h, p) for t in qkv.chunk(3, dim=-1))
    q = q * scale
    li, fg = _gates(cfg, params, xl, 0, h)               # (b,h)
    lf = layers.log_sigmoid(fg)
    m_new = torch.maximum(lf + m, li)
    alpha = torch.exp(lf + m - m_new)
    beta = torch.exp(li - m_new)
    kf, vf, qf = k.float(), v.float(), q.float()
    if pl < p:
        vf = vf[..., r0:r0 + pl]
    if pk < p:
        kf, qf = kf[..., k0:k0 + pk], qf[..., k0:k0 + pk]
    C_new = C_ * alpha[..., None, None] + beta[..., None, None] \
        * torch.einsum("bhp,bhr->bhpr", kf, vf)
    n_new = n * alpha[..., None] + beta[..., None] * kf
    num = torch.einsum("bhp,bhpr->bhr", qf, C_new)
    qn = torch.einsum("bhp,bhp->bh", qf, n_new)
    if pk < p:
        both = C.all_reduce(torch.cat([num, qn[..., None]], dim=-1), "data")
        num, qn = both[..., :pl], both[..., pl]
    den = torch.maximum(qn.abs(), torch.exp(-m_new))
    y = num / den[..., None]
    if pl < p:
        y = C.all_gather(y, "model", 2)
    y = y.reshape(b, 1, di).to(dt)
    if hl < h:
        y = y[..., h0 * p:(h0 + hl) * p]      # the rank's heads' columns
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps, ways=h // hl)
    y = y * layers.silu(xr[:, None])
    out = layers.dense(C.fetch(params["down"]), y, dt)
    return C.reduce_from(out), C_new, n_new, m_new


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
    wx, wh, bias = _slstm_weights(params, dt)
    gx = layers.dense(wx, x, dt) + bias
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
    return layers.dense(C.fetch(params["proj"]), y, dt)


def _slstm_weights(params, dt: torch.dtype):
    """(wx, wh, bias) whole in the compute dtype: under a mesh that splits
    their gate columns over ``model``, each gathered over it once
    (``collectives.gather_whole``: every rank runs the whole recurrence,
    and its gradient of each is the whole one, of which it keeps its
    block)."""
    return tuple(C.gather_whole(C.fetch(params[n]).to(dt), "model", dim)
                 for n, dim in (("wx", 1), ("wh", 1), ("bias", 0)))


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
    wx, wh, bias = _slstm_weights(params, dt)
    g = layers.dense(wx, x, dt)[:, 0] + bias + layers.dense(wh, h.to(dt), dt)
    h_new, c_new, n_new, m_new = _slstm_cell(g.float(), c, n, m)
    y = layers.rmsnorm(params["norm"], h_new[:, None].to(dt), cfg.norm_eps)
    return layers.dense(C.fetch(params["proj"]), y, dt), h_new, c_new, \
        n_new, m_new
