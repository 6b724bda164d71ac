"""Mamba2 (SSD) block: chunked training/prefill scan + O(1) decode state
update.

Port of ``repro/models/ssm.py``.  The forward calls the port's ``ssd_scan``
(the sm_90a SSD chunk kernel for CUDA tensors, its plain twin on the CPU)
where the reference calls the jnp ``ssd_chunked``: the same function at the
same chunk of 256.  :func:`ssd_chunked` is the port of that jnp function;
``ssd_scan``'s backward is its vjp, recomputed from the saved inputs (the
reference differentiates it).  Decode keeps the per-head state
h: (B, H, N, P) with the classic update

    h <- exp(dt*A) * h + dt * (B x x);   y = (C . h) + D*x

Parameters are a dict per layer (held by ``zamba.MambaLayer``): the dense
``in_proj``/``out_proj`` in the compute dtype to serve and in
``param_dtype`` (float32) to train, ``conv``, ``A_log``, ``D``,
``dt_bias`` and the ``norm`` scale in float32.  The reference's cost-probe
``mixer_skip`` mode (``launch/probe.py``) bypasses the scan: y = x in
float32, and no kernel is launched.

Under a mesh whose ``model`` axis has more than one rank, each rank runs
the layer on its own block of the heads (the reference's ``constrain`` of
``xh`` to ``("batch", "seq", "heads", None)``) in :func:`ssm_forward`:
the placement cuts ``in_proj``'s and ``conv``'s columns into contiguous
blocks that do not line up with the heads (``[z | x | B | C | dt]``), so
both are gathered over ``model`` at use (their backward reduce-scatters
the ranks' partial gradients) and sliced to the rank's columns of z, x and
dt and all of B and C; ``A_log``, ``D`` and ``dt_bias`` are sliced to its
heads (their gradients are partial: :func:`ssm_specs` names them); the
gated norm's variance over all of ``d_inner`` sums the ranks' means
(``layers.rmsnorm(ways=)``); ``out_proj``'s row block gives a partial
output summed over ``model``.  Without such a mesh every one of these
steps is the identity and the layer is the reference's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.remat_policy import tag
from repro_torch.kernels.ssm_scan.ops import ssd_scan
from repro_torch.models import layers
from repro_torch.sharding import api
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R


def _widths(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, state n, heads h, head dim p)."""
    di, h = cfg.d_inner, cfg.n_ssm_heads
    return di, cfg.ssm_state or 64, h, di // h


def ssm_init(gen: torch.Generator, cfg: ModelConfig, *,
             trainable: bool = False) -> Dict[str, torch.Tensor]:
    """The dense kernels in the compute dtype, or in ``param_dtype`` when
    ``trainable`` (as ``transformer.block_init``)."""
    dt = layers.weight_dtype(cfg, trainable)
    d = cfg.d_model
    di, n, h, _ = _widths(cfg)
    dev = gen.device
    conv = torch.randn(cfg.ssm_conv, di + 2 * n, generator=gen, device=dev)
    return {
        # fused in-proj: [z (di), x (di), B (n), C (n), dt (h)]
        "in_proj": layers.dense_init(gen, d, 2 * di + 2 * n + h, dtype=dt),
        "conv": conv * 0.1,
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "D": torch.ones(h, device=dev),
        "dt_bias": torch.zeros(h, device=dev),
        "norm": layers.rmsnorm_init(di, device=dev),
        "out_proj": layers.dense_init(gen, di, d, dtype=dt),
    }


def ssm_specs(cfg: ModelConfig):
    return api.SplitSpecs({"in_proj": layers.dense_specs("embed", "mlp"),
                           "conv": (None, "mlp"),
                           "A_log": (None,),
                           "D": (None,),
                           "dt_bias": (None,),
                           "norm": ("mlp",),
                           "out_proj": layers.dense_specs("mlp", "embed")},
                          _partial)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} x[..., k], -inf above the diagonal:
    the mask comes before the exp, so neither the exp nor its gradient
    ever sees the positive sums there (``repro/models/ssm.py:_segsum``)."""
    t = x.shape[-1]
    cs = layers.cumsum(x, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    return seg.masked_fill(upper, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256
                ) -> torch.Tensor:
    """Chunked SSD scan, the reference's jnp ``ssd_chunked`` in PyTorch ops:
    x (b, s, h, p), dt (b, s, h) softplus'd, A (h,) the log decay rate
    (``A_log``; the decay is -exp(A)), B, C (b, s, n) -> y (b, s, h, p).

    Written as the reference is (-inf masked before the exp; the
    inter-chunk recurrence a loop as its ``lax.scan``), with each three-
    or four-operand einsum taken as pairwise products, so autograd
    through it gives the reference's gradient; its cumsums are summed in
    float64 (``layers.cumsum``), as the kernel's forward sums them.
    ``ssd_scan``'s backward is its vjp."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)

    dA = dtc * (-torch.exp(A))                           # (b,nc,q,h)
    dA_cum = layers.cumsum(dA, 2)

    # ---- intra-chunk (quadratic within q) --------------------------------
    L = torch.exp(_segsum(dA.transpose(2, 3)))           # (b,nc,h,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)     # (b,nc,q,q)
    w = scores[:, :, None] * L * dtc.transpose(2, 3)[..., None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", w, xc)

    # ---- chunk states -----------------------------------------------------
    decay_to_end = torch.exp(dA_cum[:, :, -1:] - dA_cum)  # (b,nc,q,h)
    xw = xc * (dtc * decay_to_end)[..., None]
    states = torch.einsum("bcqn,bcqhp->bchnp", Bc, xw)   # (b,nc,h,n,p)

    # ---- inter-chunk recurrence (the only sequential part) ---------------
    chunk_decay = torch.exp(dA_cum[:, :, -1])            # (b,nc,h)
    carry = torch.zeros(b, h, n, p, dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                               # emit PREVIOUS
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (b,nc,h,n,p)

    # ---- inter-chunk contribution -----------------------------------------
    y_off = torch.einsum("bcqn,bchnp->bcqhp", Cc, prev_states) \
        * torch.exp(dA_cum)[..., None]
    y = (y_diag + y_off).reshape(b, nc * q, h, p)
    return y[:, :s]


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, n, h, _ = _widths(cfg)
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def rank_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(first head, heads) of the mamba heads this rank computes: all of
    them without a mesh or on a ``model`` axis of one rank, else its block
    of them.  The heads are split whenever the axis has more ranks (the
    reference's ``heads`` rule, or every rank computing all of them where
    the rule is off the axis: the same function)."""
    mesh = R.current_mesh()
    m = 1 if mesh is None else mesh.shape.get("model", 1)
    h = cfg.n_ssm_heads
    if h % m:
        raise NotImplementedError(
            f"{cfg.name}: {h} mamba heads do not split over a model axis of "
            f"{m} ranks (ROADMAP item 11: only whole heads a rank are run)")
    return (mesh.coords()["model"] * (h // m) if m > 1 else 0), h // m


def _partial(cfg: ModelConfig, shardings) -> Tuple[str, ...]:
    """The per-head parameters, where the ranks split the heads: each
    rank's gradient covers only its heads."""
    return ("A_log", "D", "dt_bias") \
        if rank_heads(cfg)[1] < cfg.n_ssm_heads else ()


def _columns(w: torch.Tensor, spans) -> torch.Tensor:
    """The columns of ``w`` in the (start, length) ``spans``, in order."""
    return torch.cat([w[:, a:a + n] for a, n in spans], dim=1)


def ssm_forward(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Prefill path.  Under a mesh that splits
    the heads (:func:`rank_heads`), the layer on this rank's heads, its
    partial output summed over ``model``."""
    dt_ = layers.dtype_of(cfg.dtype)
    b, s, _ = x.shape
    di, n, h, p = _widths(cfg)
    h0, hl = rank_heads(cfg)
    c0, cl = h0 * p, hl * p                      # the rank's d_inner columns
    split = hl < h
    if split:
        for name, dim in (("in_proj", 1), ("conv", 1), ("norm", 0),
                          ("out_proj", 0)):
            if not C.split_over(params[name], dim):
                raise NotImplementedError(
                    f"{cfg.name}: {name}'s placement does not split its "
                    "mlp dim over the model axis (ROADMAP item 11)")
    x = C.copy_to(x)
    # an FSDP shard is gathered at use (``C.fetch``), then the column
    # blocks over ``model``: the compute dtype's copy, the same values in
    # half the bytes of a float32 gather in bf16
    w_in = C.gather(C.fetch(params["in_proj"]).to(dt_), "model", 1)
    if split:
        w_in = _columns(w_in, [(c0, cl), (di + c0, cl), (2 * di, 2 * n),
                               (2 * di + 2 * n + h0, hl)])
    z, xin, B, Cm, dt = torch.split(layers.dense(w_in, x, dt_),
                                    [cl, cl, n, n, hl], dim=-1)

    # depthwise causal conv over (x, B, C), summed tap by tap in the
    # compute dtype in the reference's order (F.conv1d rounds otherwise)
    xbc = torch.cat([xin, B, Cm], dim=-1)
    w = C.gather(params["conv"].to(dt_), "model", 1)  # (K, di+2n)
    if split:
        w = _columns(w, [(c0, cl), (di, 2 * n)])      # (K, cl+2n)
    kk = w.shape[0]
    xbc_pad = torch.nn.functional.pad(xbc, (0, 0, kk - 1, 0))
    xbc = sum(xbc_pad[:, i:i + s] * w[i] for i in range(kk))
    xbc = layers.silu(xbc)
    xin, B, Cm = torch.split(xbc, [cl, n, n], dim=-1)

    heads = slice(h0, h0 + hl)
    dt = layers.softplus(dt.float() + params["dt_bias"][heads][None, None])
    xh = tag("ssm_in", xin.reshape(b, s, hl, p))
    if cfg.mixer_skip:
        # cost-probe mode: the SSD kernel's cost is added analytically
        # (launch/costs.py)
        y = xh.float()
    else:
        y = ssd_scan(xh.float(), dt, params["A_log"][heads], B.float(),
                     Cm.float())
    y = y + params["D"][heads][None, None, :, None] * xh.float()
    y = y.reshape(b, s, cl).to(dt_)
    # the gated RMSNorm over all of d_inner
    y = layers.rmsnorm(params["norm"], y * layers.silu(z), cfg.norm_eps,
                       ways=h // hl)
    return C.reduce_from(layers.dense(C.fetch(params["out_proj"]), y, dt_))


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, *, device
                   ) -> Dict[str, torch.Tensor]:
    """float32 state, as the reference's.  The conv window holds values
    already rounded to the compute dtype, so float32 storage keeps them
    exactly where the reference's becomes bf16 after the first step."""
    di, n, h, p = _widths(cfg)
    return {
        "h": torch.zeros(n_layers, batch, h, n, p, device=device),
        "conv": torch.zeros(n_layers, batch, cfg.ssm_conv - 1, di + 2 * n,
                            device=device),
    }


def ssm_state_specs():
    """The decode state's logical axes (the reference's): ``h`` splits its
    state dim N over ``state``, the conv window its ``[x | B | C]``
    columns over ``mlp`` in contiguous blocks."""
    return {"h": (None, "batch", None, "state", None),
            "conv": (None, "batch", None, "mlp")}


def ssm_decode_step(cfg: ModelConfig, params, x: torch.Tensor,
                    state_h: torch.Tensor, state_conv: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token state update.  x: (B,1,d); state_h: (B,H,N,P);
    state_conv: (B, K-1, di+2n).  Returns (y, new_h, new_conv).

    Under a mesh the state keeps the reference's placement and the
    compute fits itself to it (every collective moves B x a width):
    ``in_proj``'s column block of the projection is all-gathered over
    ``model``; the rank's block of the conv window's columns takes its
    block of the new column and its block of the filtered window is
    all-gathered; ``state_h`` holds a block of N, so the rank updates it
    for all heads and sums its partial y over ``model``; the gated norm
    and ``out_proj`` run on the rank's rows of ``d_inner``, their partial
    output summed over ``model``."""
    dt_ = layers.dtype_of(cfg.dtype)
    b = x.shape[0]
    di, n, h, p = _widths(cfg)

    zxbcdt = layers.dense(C.fetch(params["in_proj"]), x, dt_)[:, 0]
    if C.split_over(params["in_proj"], 1):
        zxbcdt = C.all_gather(zxbcdt, "model", 1)
    z, xin, B, Cm, dt = _split(zxbcdt, cfg)

    # rolling conv buffer: this rank's block of its columns
    xbc_new = torch.cat([xin, B, Cm], dim=-1)                  # (B, di+2n)
    width = state_conv.shape[-1]
    if width < di + 2 * n:
        c0 = C.block_start_of(width, di + 2 * n)
        xbc_new = xbc_new[:, c0:c0 + width]
    w = C.fetch(params["conv"]).to(dt_)
    if w.shape[-1] != width:
        raise NotImplementedError(
            f"{cfg.name}: the conv window's placement does not match the "
            "conv weight's (ROADMAP item 11)")
    window = torch.cat([state_conv.to(dt_), xbc_new[:, None]], dim=1)
    xbc = layers.silu(torch.einsum("bkc,kc->bc", window, w))
    new_conv = window[:, 1:]
    if width < di + 2 * n:
        xbc = C.all_gather(xbc, "model", 1)
    xin, B, Cm = torch.split(xbc, [di, n, n], dim=-1)

    dt = layers.softplus(dt.float() + params["dt_bias"])        # (B,h)
    dA = torch.exp(dt * (-torch.exp(params["A_log"]))[None])   # (B,h)
    xh = xin.reshape(b, h, p).float()
    nl = state_h.shape[2]                  # this rank's block of N
    if nl < n:
        n0 = C.block_start_of(nl, n)
        B, Cm = B[:, n0:n0 + nl], Cm[:, n0:n0 + nl]
    dBx = torch.einsum("bn,bh,bhp->bhnp", B.float(), dt, xh)
    new_h = state_h * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), new_h)
    if nl < n:
        y = C.all_reduce(y, "model")
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, di).to(dt_)
    y = y * layers.silu(z[:, None])
    split = C.split_over(params["out_proj"], 0)
    if split:
        rows = params["out_proj"].shape[0]
        r0 = C.block_start(params["out_proj"], 0)
        y = y[..., r0:r0 + rows]
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps,
                       ways=di // y.shape[-1])
    out = layers.dense(C.fetch(params["out_proj"]), y, dt_)
    return (C.reduce_from(out) if split else out), new_h, new_conv
