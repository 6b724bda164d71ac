"""Cost probes: the operations and bytes one step of a cell moves on the
card, counted from what PyTorch dispatches, extrapolated to full depth.

Port of ``repro/launch/probe.py`` for one card.  A probe builds the model
one and two "periods" deep (a period is the repeating unit: one block, one
cross-attention super-block, one shared-attention group, one sLSTM group,
one encoder and decoder layer pair), runs one micro-batch of the step, and
extrapolates:

    total = microbatches * (fixed + per_period * n_periods)

with fixed = probe1 - per_period (embedding, unembedding, loss), plus the
hybrid family's tail of mamba layers as a fraction of a period, as the
reference adds it.  A train step's AdamW update is counted apart and once
per step (the reference counts it once per micro-batch and calls that
negligible; on one card it is not: it streams every parameter's fp32
state).

The step is ``make_train_step``'s value-and-grad and AdamW update
(checkpoint replays included), ``make_prefill_step``'s forward, or
``make_decode_step``'s one token against a full cache.  It runs in probe
mode (``attention_impl="skip"``, ``mixer_skip``, ``mlp_skip``,
``moe_ffn_skip``): the four hand-written kernels are ``ctypes`` calls that
no dispatch mode sees, so every one is bypassed and its kernel-true cost
(``launch/costs.py``) added back, as the reference does with its Pallas
kernels.  Probe mode launches no kernel.

* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
  convolutions and attention, not elementwise work (so they are not
  comparable with XLA's ``cost_analysis``).
* Bytes come from :class:`ByteCounter`, a ``TorchDispatchMode`` that sums
  the operand and result bytes of every ATen op that is not a view: the
  eager traffic of the unfused port.
* On the card, each probe's ``max_memory_allocated`` is extrapolated the
  same way (without the micro-batch factor: micro-batches run in turn).

One card has no collectives, so there is no collective term.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.launch import costs

PROBE_MODE = dict(attention_impl="skip", mixer_skip=True, mlp_skip=True,
                  moe_ffn_skip=True)
COUNTED = ("flops", "bytes")


def probe_config(cfg: ModelConfig, periods: int, seq_len: int
                 ) -> ModelConfig:
    """Same-family config in probe mode with ``periods`` repeating units.
    (``seq_len`` is the reference's argument, which sizes its flash blocks;
    probe mode runs no flash kernel.)"""
    over = dict(PROBE_MODE)
    if cfg.family == "vlm":
        over["n_layers"] = cfg.cross_attn_every * periods
    elif cfg.family == "hybrid":
        over["n_layers"] = cfg.shared_attn_every * periods
    elif cfg.family == "ssm" and cfg.slstm_every:
        over["n_layers"] = cfg.slstm_every * periods
    elif cfg.family == "audio":
        over["n_layers"] = periods
        over["encoder_layers"] = periods
    else:
        over["n_layers"] = periods
    return dataclasses.replace(cfg, **over)


def n_periods(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "hybrid":
        # tail layers counted fractionally (they are mamba blocks only)
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.n_layers // cfg.slstm_every
    return cfg.n_layers


def slstm_correction(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Dict[str, float]:
    """The sLSTM recurrence's per-period FLOPs beyond its first time step
    (the ``wh`` matvec, 8 b d^2 a step, and ~20 b d elementwise; x3 in
    training), at one card: the part the reference's scanned probe cannot
    see.  The port's sLSTM is an eager loop, so its probe counts every
    step's matvec itself; this is the analytic figure to hold it to."""
    if cfg.family != "ssm" or not cfg.slstm_every:
        return {"flops": 0.0, "bytes": 0.0}
    d = cfg.d_model
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    per_step = 8 * b * d * d + 20 * b * d
    mult = 3.0 if shape.kind == "train" else 1.0
    return {"flops": float((s - 1) * per_step * mult), "bytes": 0.0}


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of the operands and results of every ATen op that is
    not a view (views move nothing), and counts those ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_view(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            self.ops += 1
        return out


@contextlib.contextmanager
def counting():
    """``(flop counter, byte counter)`` over everything run inside."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with flops, nbytes:
        yield flops, nbytes


class _Split:
    """Reads both counters before and after the optimizer's update, so a
    train probe can count the update apart from the value-and-grad."""

    def __init__(self, update_):
        self.update_ = update_
        self.counters = None
        self.flops = self.bytes = 0

    def __call__(self, *args, **kwargs):
        fc, bc = self.counters
        f0, b0 = fc.get_total_flops(), bc.bytes
        out = self.update_(*args, **kwargs)
        self.flops += fc.get_total_flops() - f0
        self.bytes += bc.bytes - b0
        return out


def _batch(cfg: ModelConfig, b: int, s: int, dev: torch.device
           ) -> Dict[str, torch.Tensor]:
    """Tokens and targets from a seeded generator, and the stubbed
    frontend's embeddings for the multimodal families."""
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab, (b, s + 1), generator=g,
                        dtype=torch.int32)
    batch = {"tokens": ids[:, :-1], "targets": ids[:, 1:]}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model,
                                          generator=g)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(b, cfg.image_tokens,
                                            cfg.d_model, generator=g)
    return {k: v.to(dev) for k, v in batch.items()}


def count_step(cfg: ModelConfig, shape: ShapeConfig, *,
               device: DeviceLike = None, seed: int = 0) -> Dict:
    """Counts of one step of ``shape`` (one micro-batch: the whole
    ``shape.global_batch``) of the model ``cfg`` as given, with its
    parameter bytes, its decode state's bytes and, on the card, its peak
    allocated bytes from before the model is built (parameters, optimizer
    state and the step's transients)."""
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                        make_train_step)

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        # the step's own bytes: what an earlier probe left to the garbage
        # collector (its model's reference cycles) is freed first, and
        # what is still allocated is not counted
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    train = shape.kind == "train"
    params = model.init(seed, device=dev, trainable=train)
    b, s = shape.global_batch, shape.seq_len
    batch = _batch(cfg, b, s, dev)
    split = None
    state_bytes = 0
    if train:
        opt = make_optimizer("adamw")
        opt_state = opt.init(dict(params.named_parameters()))
        split = _Split(opt.update_)
        opt = dataclasses.replace(opt, update_=split)
        step = make_train_step(model, opt, shape).fn

        def run():
            step(params, opt_state, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(model)

        def run():
            step(params, batch)
    else:
        state = model.decode_init(b, s, device=dev)
        state_bytes = _nbytes(state)
        step = make_decode_step(model)
        one = {"tokens": batch["tokens"][:, -1],
               "cache_len": torch.full((b,), s - 1, dtype=torch.int32,
                                       device=dev)}

        def run():
            step(params, state, one)
    synchronize(dev)
    with counting() as (fc, bc):
        if split is not None:
            split.counters = (fc, bc)
        run()
        synchronize(dev)
    out = {"flops": float(fc.get_total_flops()), "bytes": float(bc.bytes),
           "ops": bc.ops,
           "param_bytes": _nbytes(list(params.parameters())
                                  + list(params.buffers())),
           "state_bytes": state_bytes,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev) - base
                          if on_card else None)}
    if split is not None:
        out["update_flops"] = float(split.flops)
        out["update_bytes"] = float(split.bytes)
    return out


# ---------------------------------------------------------------------------
# extrapolation
# ---------------------------------------------------------------------------

def _linear(c1: float, c2: float, periods: int, tail: float):
    """(fixed, per period, at ``periods`` + ``tail`` periods)."""
    per = c2 - c1
    fixed = max(c1 - per, 0.0)
    return fixed, per, fixed + per * (periods + tail)


def run_probe(cfg: ModelConfig, shape: ShapeConfig, *, microbatches: int = 1,
              device: DeviceLike = None) -> Dict:
    """The extrapolated cost of one step of the whole (``cfg``, ``shape``)
    cell: ``shape.global_batch`` sequences in ``microbatches``
    micro-batches, with the kernels' analytic terms added."""
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatches} micro-batches")
    micro = dataclasses.replace(
        shape, global_batch=shape.global_batch // microbatches)
    c1 = count_step(probe_config(cfg, 1, shape.seq_len), micro,
                    device=device)
    c2 = count_step(probe_config(cfg, 2, shape.seq_len), micro,
                    device=device)
    L = n_periods(cfg)
    tail = 0.0
    if cfg.family == "hybrid" and cfg.n_layers % cfg.shared_attn_every:
        # the tail's extra mamba layers ~ (tail / k) of a period
        tail = (cfg.n_layers % cfg.shared_attn_every) / cfg.shared_attn_every

    out: Dict = {"n_periods": L, "tail_periods": tail,
                 "microbatches": microbatches,
                 "microbatch": micro.global_batch}
    update = {}
    for key in COUNTED:
        step1 = c1[key] - c1.get(f"update_{key}", 0.0)
        step2 = c2[key] - c2.get(f"update_{key}", 0.0)
        fixed, per, total = _linear(step1, step2, L, tail)
        out[f"{key}_fixed"], out[f"{key}_per_period"] = fixed, per
        counted = microbatches * total
        if "update_flops" in c1:
            u = _linear(c1[f"update_{key}"], c2[f"update_{key}"], L, tail)
            update[key] = u[2]
            counted += u[2]
        out[f"counted_{key}"] = counted
    if update:
        out["update"] = update
    kt = costs.kernel_true(cfg, shape, costs.skipped_kernels(cfg, shape.kind))
    out["kernel_true"] = kt
    out["flops"] = out["counted_flops"] + kt["flops"]
    out["bytes"] = out["counted_bytes"] + kt["bytes"]
    out["param_bytes"] = _linear(c1["param_bytes"], c2["param_bytes"], L,
                                 tail)[2]
    out["state_bytes"] = microbatches * _linear(
        c1["state_bytes"], c2["state_bytes"], L, tail)[2]
    out["peak_bytes"] = None if c1["peak_bytes"] is None else _linear(
        c1["peak_bytes"], c2["peak_bytes"], L, tail)[2]
    out["probe1"], out["probe2"] = c1, c2
    return out


def check_linearity(cfg: ModelConfig, shape: ShapeConfig, probe: Dict, *,
                    device: DeviceLike = None) -> Dict[str, float]:
    """A third probe at 3 periods (one micro-batch, update included)
    against probe1 + 2 per_period: the relative miss of each count."""
    micro = dataclasses.replace(shape, global_batch=probe["microbatch"])
    c3 = count_step(probe_config(cfg, 3, shape.seq_len), micro,
                    device=device)
    c1, c2 = probe["probe1"], probe["probe2"]
    miss = {}
    for key in COUNTED:
        want = c1[key] + 2 * (c2[key] - c1[key])
        miss[key] = abs(c3[key] - want) / max(abs(c3[key]), 1.0)
    return miss


def forward_period_matmul_flops(cfg: ModelConfig, tokens: int) -> int:
    """The matmul FLOPs of one forward period of a dense transformer in
    probe mode, reckoned from the config's shapes: the q, k, v and o
    projections (attention and the MLP are bypassed)."""
    if cfg.family != "dense":
        raise ValueError("reckoned for the dense family")
    d, hd = cfg.d_model, cfg.head_dim
    widths = 2 * cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd
    return 2 * tokens * d * widths
