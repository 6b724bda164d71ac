#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's serving path on one CUDA card.

    python3 tools/profile_torch_serve.py [--arch zamba2-7b | xlstm-1.3b |
                                          granite-moe-1b-a400m]
    python3 tools/profile_torch_serve.py --paper-trunk

Profiles, with ``torch.profiler``, one model at full width (default
llama3.2-3b; random weights from seed 0, bf16, ``attention_impl="pallas"``):

- one prefill step at B = 2, S = 4096 (the flash kernel in every attention
  layer and the fused SwiGLU kernel in every MLP; for zamba2-7b also the
  SSD kernel in every mamba layer; for xlstm-1.3b the mLSTM kernel in every
  mLSTM block, beside the sLSTM blocks' loop over time; for
  granite-moe-1b-a400m the SwiGLU kernel once a layer for all 32 experts,
  between the one-hot dispatch and combine products);
- four greedy decode steps after a prefill of 4 prompts (the ``generate``
  server's loop): 512 tokens each in one batched prefill, or, for a family
  without one, 128 tokens filled token by token.

For each it prints one JSON line: the wall time, the device time summed
over kernels (``device_busy_ms``), the device time of host<->device copies
(``copy_ms``), the device's idle share of the wall time (the share in
which no kernel ran; copies do not count, since they may run on a stream
of their own beside the kernels), the kernels and copies that
took the most device time, and the host time spent inside each kind of
sequence mixer (``ssm_forward``, ``mlstm_forward``, ``slstm_forward``) and
MoE layer (``moe_forward``; each call is wrapped in a profiler range here,
not in the model code): for a loop the host issues op by op, such as the
sLSTM recurrence, that time is its share of the wall time.  Needs the
card; it raises without one.

``--paper-trunk`` profiles the paper's path instead: one training step of
the llama3.2-3b MLP trunk (``transformer_mlp_stack()``: 28 x (3072 -> 8192
relu -> 3072), MSE head; He-init weights from seed 5, inputs at std
2^-14, 4096 rows, fp32, TF32 off) replayed from ``compile_plan``, on
``async`` over the default plan (54 swap-outs and 54 prefetches on the
CUDA copy stream, its pinned pool reserved first) and on the no-swap
plan, each after a warm-up step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.serve import fill  # noqa: E402
from repro_torch.models import moe, ssm, xlstm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step)

TOP = 12
MIXERS = ((ssm, "ssm_forward"), (xlstm, "mlstm_forward"),
          (xlstm, "slstm_forward"), (moe, "moe_forward"))
RANGE = "mixer:"


def annotate_mixers() -> None:
    """Wrap each mixer's prefill function in a named profiler range (the
    model code calls them through their modules)."""
    for mod, name in MIXERS:
        def ranged(*args, _fn=getattr(mod, name), _label=RANGE + name):
            with record_function(_label):
                return _fn(*args)
        setattr(mod, name, ranged)


def _device_us(evt) -> float:
    """Device time of a kernel row; 0 for host-side operator rows, whose
    device time is that of the kernels they launched (counted there), and
    for the device-side copies of the mixer ranges, which span kernels
    rather than run any."""
    if (evt.device_type != DeviceType.CUDA or evt.key.startswith(RANGE)
            or evt.key == "Command Buffer Full"):
        return 0.0      # the last is a CUPTI launch-queue marker
    return float(getattr(evt, "self_device_time_total", 0.0)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def profiled(label: str, fn) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    mixers = {e.key[len(RANGE):]: {"calls": e.count,
                                   "host_ms": e.cpu_time_total / 1e3,
                                   "share_of_wall": e.cpu_time_total / 1e6
                                   / wall}
              for e in events
              if e.key.startswith(RANGE) and e.device_type == DeviceType.CPU}
    rows = [(e.key, e.count, _device_us(e)) for e in events]
    rows = [r for r in rows if r[2] > 0]
    # copies may run on a stream of their own beside the kernels, so the
    # card counts as busy for the kernels' time only
    copy_us = sum(us for k, _, us in rows if k.startswith("Memcpy"))
    busy_us = sum(r[2] for r in rows) - copy_us
    rows.sort(key=lambda r: -r[2])
    print(json.dumps({
        "profile": label, "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "copy_ms": copy_us / 1e3,
        "top": [{"name": k[:90], "calls": c, "device_ms": us / 1e3,
                 "share": us / (busy_us + copy_us)}
                for k, c, us in rows[:TOP]],
        "mixers_host": mixers,
    }), flush=True)


def profile_paper_trunk() -> None:
    from repro_torch.core.exec.backends import AsyncDeviceBackend
    from repro_torch.core.plan import MemoryPlanConfig, compile_plan
    from repro_torch.core.zoo import transformer_mlp_stack

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g, batch = transformer_mlp_stack(), 4096
    swapped = compile_plan(g, MemoryPlanConfig(), batch=batch)
    flat = compile_plan(g, MemoryPlanConfig(swap=False), batch=batch)
    params = swapped.init_params(torch.Generator("cuda").manual_seed(5))
    gen = torch.Generator("cuda").manual_seed(6)
    x = torch.randn((batch,) + tuple(g.input_shape), generator=gen,
                    device="cuda") * 2.0 ** -14
    y = torch.randn((batch,) + tuple(g.label_shape), generator=gen,
                    device="cuda")
    backend = AsyncDeviceBackend()
    backend.make_engine(x.device).reserve(swapped.host_pool_bytes)
    for cp, label in ((swapped, "async_swapped"), (flat, "no_swap")):
        def step(cp=cp):
            cp.loss_and_grads(params, x, y, executor=backend)
        step()                                           # warm-up
        profiled(f"transformer_mlp_stack_b{batch}_{label}", step)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b", choices=sorted(ARCHS))
    ap.add_argument("--paper-trunk", action="store_true",
                    help="profile a training step of the paper's path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    if args.paper_trunk:
        profile_paper_trunk()
        return 0
    annotate_mixers()
    cfg = dataclasses.replace(ARCHS[args.arch], attention_impl="pallas")
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(7)

    tokens = torch.randint(0, cfg.vocab, (2, 4096), generator=g,
                           device="cuda")
    prefill = make_prefill_step(model)
    prefill(params, {"tokens": tokens})                  # warm-up
    profiled(f"{cfg.name}_prefill_step_b2_s4096",
             lambda: prefill(params, {"tokens": tokens}))

    b, plen = 4, 512 if model.prefill_fn is not None else 128
    prompts = torch.randint(0, cfg.vocab, (b, plen), generator=g,
                            device="cuda")
    decode = make_decode_step(model)
    logits, state, _ = fill(model, decode, params,
                            model.decode_init(b, plen + 16), prompts)
    cur = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)

    def steps(n, start):
        nonlocal cur, state
        for i in range(n):
            lens = torch.full((b,), start + i, dtype=torch.int32,
                              device="cuda")
            out, state = decode(params, state,
                                {"tokens": cur, "cache_len": lens})
            cur = out[:, :cfg.vocab].argmax(-1).to(torch.int32)

    steps(2, plen)                                       # warm-up
    profiled(f"{cfg.name}_decode_4_steps_b4_ctx{plen}",
             lambda: steps(4, plen + 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
