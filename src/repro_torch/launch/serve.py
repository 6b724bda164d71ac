"""Serving launcher: multi-tenant personalization + LM generation.

Port of ``repro/launch/serve.py``.  Two subcommands::

    # N simulated users fine-tuning a zoo model over bucketed traffic
    python -m repro_torch.launch.serve personalize --model lenet5 \
        --users 8 --steps 3 --buckets 8,16 --max-live 8 --json stats.json

    # batched prefill + greedy decode on an LM arch
    python -m repro_torch.launch.serve generate --arch llama3.2-3b \
        --requests 4 --prompt-len 512 --gen-tokens 16

``personalize`` drives :class:`repro_torch.serve.PersonalizationService`:
every user shares one frozen base tree and one compiled memory plan per
batch bucket; admission control splits the device arena between live
sessions, the interleaved drain runs every session's swaps on one CUDA
copy stream, and the stats dump shows the QoS counters (cache hit rate,
per-session peak bytes vs share, steps/sec, rejections).

In ``generate``, requests are batched, prefilled with one fused full-
prompt forward that fills the KV cache (``model.prefill_fn``; the dense
and MoE families, e.g. ``--arch granite-moe-1b-a400m``), then decoded
token by token with greedy sampling. A family with no ``prefill_fn`` (the
hybrid and the xLSTM, whose states are recurrent, and the multimodal
ones, whose states are cross-attentive) fills its state token by token
through the decode step, as ``--sequential-prefill`` forces for any
family: ``--arch zamba2-7b``, ``--arch xlstm-1.3b``, ``--arch
whisper-tiny`` and ``--arch llama-3.2-vision-11b`` serve so. The
multimodal decode states' cross-attention keys and values (``xk``/``xv``)
start as zeros and, as in the reference, ``generate`` writes nothing
there: the stubbed frontends give it no frames or image. Weights are
random from seed 0. It runs on the CUDA card; ``--device cpu`` runs
the plain PyTorch path on the host (both subcommands). ``--test-mesh``
keeps its reference meaning: the reduced config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model import Model
from repro_torch.train.step import make_decode_step


# ---------------------------------------------------------------------------
# personalize: the multi-tenant fine-tuning loop
# ---------------------------------------------------------------------------

def _parse_qos(spec: str):
    """Parse ``name:weight:slots,...`` into QosClass objects plus a
    flattened slot list used to deal users across classes in order."""
    from repro_torch.serve import QosClass

    classes, deal = [], []
    for part in spec.split(","):
        fields = part.split(":")
        if not 1 <= len(fields) <= 3 or not fields[0]:
            raise SystemExit(f"bad --qos entry {part!r}; "
                             "expected name[:weight[:slots]]")
        name = fields[0]
        weight = float(fields[1]) if len(fields) > 1 else 1.0
        slots = int(fields[2]) if len(fields) > 2 else 1
        classes.append(QosClass(name, weight, slots=slots))
        deal.extend([name] * slots)
    return tuple(classes), deal


def run_personalize(args: argparse.Namespace) -> None:
    from repro_torch.core import MemoryPlanConfig
    from repro_torch.core.zoo import ZOO
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.serve import PersonalizationService
    from repro_torch.serve.buckets import dummy_batch

    if args.model not in ZOO:
        raise SystemExit(f"unknown zoo model {args.model!r}; "
                         f"choose from {sorted(ZOO)}")
    device = resolve_device(args.device)
    graph = ZOO[args.model]()
    buckets = tuple(int(b) for b in args.buckets.split(","))
    config = MemoryPlanConfig(executor=args.executor)
    injector = None
    if args.kill_user is not None:
        injector = FaultInjector()
        injector.arm_kill(f"session:u{args.kill_user}",
                          after=args.kill_after)

    qos_classes, qos_of = None, {}
    max_live = args.max_live
    if args.qos:
        qos_classes, deal = _parse_qos(args.qos)
        # deal users across the declared slots in order, wrapping so
        # --users larger than the slot total still gets a class label
        qos_of = {f"u{u}": deal[u % len(deal)] for u in range(args.users)}
        # admission requires the class slots to sum to the session cap
        max_live = len(deal)

    budget = args.device_budget_mb * (1 << 20) if args.device_budget_mb \
        else None
    svc = PersonalizationService(
        graph, buckets=buckets, max_live_sessions=max_live,
        device_budget_bytes=budget, config=config, lr=args.lr,
        qos=qos_classes, interleave=args.interleave,
        bus_gbps=args.bus_gbps if args.bus_gbps > 0 else None,
        bus_latency_s=args.bus_latency,
        injector=injector, seed=args.seed, device=device)
    t0 = time.time()
    svc.warmup()
    t_warm = time.time() - t0
    print(f"warmup: {len(svc.buckets)} buckets compiled + replayed in "
          f"{t_warm:.2f}s; arena share = "
          f"{svc.admission.arena_share_bytes} B/session")

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for step in range(args.steps):
        # enqueue the whole round, then drain once: in interleaved mode
        # the scheduler round-robins every user's cursor at phase
        # boundaries, hiding one tenant's DMA under another's compute;
        # with --no-interleave the same queue drains FIFO
        reqs = []
        for u in range(args.users):
            # bucketed traffic: odd users send short batches (padded up),
            # even users fill the largest bucket
            n = int(rng.integers(1, buckets[0] + 1)) if u % 2 \
                else buckets[-1]
            x, y = dummy_batch(graph, n, seed=step * args.users + u,
                               device=device)
            reqs.append(svc.enqueue(f"u{u}", x, y,
                                    qos=qos_of.get(f"u{u}")))
        svc.drain()
        for u, req in enumerate(reqs):
            res = req.result
            tag = f"loss={res.loss:.4f} bucket={res.bucket}" \
                if res.ok else res.reason
            print(f"  step {step} u{u}: {res.status} {tag}")
    synchronize(device)
    t_total = time.time() - t0

    rep = svc.report()
    rep["driver"] = {"users": args.users, "steps": args.steps,
                     "device": str(device),
                     "wall_time_s": round(t_total, 3)}
    sched = rep.get("scheduler")
    if args.interleave and sched:
        hidden = sched["hidden_dma_s"] + sched["opt_hidden_dma_s"]
        exposed = sched["exposed_dma_s"] + sched["opt_exposed_dma_s"]
        print(f"interleaved drain: {hidden*1e3:.1f} ms DMA hidden under "
              f"compute ({sched['cross_hidden_dma_s']*1e3:.1f} ms under "
              f"*other* sessions', {sched['cross_hidden_clock']} clock), "
              f"{exposed*1e3:.1f} ms exposed")
    print(json.dumps(rep, indent=2, default=str))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2, default=str)
        print(f"stats written to {args.json}")


# ---------------------------------------------------------------------------
# generate: batched prefill + greedy decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor      # (B, gen_tokens) greedy ids
    mode: str                 # "batched" | "sequential" prefill
    prefill_s: float
    decode_s: float


def _lengths(b: int, n: int, dev: torch.device) -> torch.Tensor:
    return torch.full((b,), n, dtype=torch.int32, device=dev)


@torch.no_grad()
def fill(model: Model, decode: Callable, params, state,
         prompts: torch.Tensor, *, sequential: bool = False):
    """Fill the decode ``state`` with ``prompts`` (B, P): one batched
    ``model.prefill_fn`` call, or token by token through ``decode`` (a
    ``make_decode_step`` function) when asked or when the model has no
    ``prefill_fn``.  Returns (last logits, state, "batched" | "sequential")."""
    if sequential or model.prefill_fn is None:
        b, plen = prompts.shape
        for t in range(plen):
            logits, state = decode(params, state, {
                "tokens": prompts[:, t],
                "cache_len": _lengths(b, t, prompts.device)})
        return logits, state, "sequential"
    logits, state = model.prefill_fn(params, state, prompts)
    return logits, state, "batched"


@torch.no_grad()
def generate(model: Model, params, prompts: torch.Tensor, gen_tokens: int,
             *, sequential_prefill: bool = False) -> Generation:
    """Prefill ``prompts`` (B, P) into a fresh decode state (``fill``), then
    greedy-decode ``gen_tokens`` tokens.  Times are host clock around work
    that ends in a device synchronise."""
    cfg = model.cfg
    dev = prompts.device
    b, plen = prompts.shape
    decode = make_decode_step(model)
    state = model.decode_init(b, plen + gen_tokens + 8, device=dev)

    synchronize(dev)
    t0 = time.perf_counter()
    logits, state, mode = fill(model, decode, params, state, prompts,
                               sequential=sequential_prefill)
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    cur = logits[:, :cfg.vocab].argmax(dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        out.append(cur)
        logits, state = decode(params, state, {
            "tokens": cur, "cache_len": _lengths(b, plen + i, dev)})
        cur = logits[:, :cfg.vocab].argmax(dim=-1).to(torch.int32)
    synchronize(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(out, dim=1), mode, t_prefill, t_decode)


def run_generate(args: argparse.Namespace) -> None:
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model, reduce_config

    cfg = ARCHS[args.arch]
    if args.test_mesh:
        cfg = reduce_config(cfg)
    model = build_model(cfg)
    device = resolve_device(args.device)
    params = model.init(0, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(args.requests, args.prompt_len), dtype=np.int32)
    gen = generate(model, params, torch.from_numpy(prompts).to(device),
                   args.gen_tokens,
                   sequential_prefill=args.sequential_prefill)
    b = args.requests
    print(f"prefill ({gen.mode}): {gen.prefill_s * 1000:.1f} ms for "
          f"{b}x{args.prompt_len} tok")
    print(f"decode:  {gen.decode_s * 1000:.1f} ms for {b}x{args.gen_tokens} "
          f"tok ({b * args.gen_tokens / max(gen.decode_s, 1e-9):.1f} tok/s)")
    print("generated token ids (first request):", gen.tokens[0].tolist())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("personalize",
                       help="multi-tenant per-user fine-tuning")
    p.add_argument("--model", default="lenet5", help="zoo model name")
    p.add_argument("--users", type=int, default=8)
    p.add_argument("--steps", type=int, default=2,
                   help="fine-tune rounds per user")
    p.add_argument("--buckets", default="8,16",
                   help="comma-separated batch buckets")
    p.add_argument("--max-live", type=int, default=8)
    p.add_argument("--device-budget-mb", type=int, default=0,
                   help="arena budget (MiB); 0 derives it from the plans")
    p.add_argument("--executor", default="sim", choices=("sim", "async"))
    p.add_argument("--interleave", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="phase-interleave live sessions so one tenant's "
                        "DMA overlaps another's compute "
                        "(--no-interleave = synchronous FIFO drain)")
    p.add_argument("--qos", default="",
                   help="comma-separated QoS classes as "
                        "name[:weight[:slots]], e.g. "
                        "'premium:2.0:2,standard:1.0:6'; users are dealt "
                        "across the declared slots in order")
    p.add_argument("--bus-gbps", type=float, default=0.0,
                   help="emulated host<->device bus bandwidth (GB/s), CPU "
                        "only; 0 disables pacing")
    p.add_argument("--bus-latency", type=float, default=0.0,
                   help="emulated per-access bus latency (seconds); the "
                        "sync FIFO path pays it per transfer, the async "
                        "engine amortizes it across the queue")
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--kill-user", type=int, default=None,
                   help="arm a fault-injection kill for user uN")
    p.add_argument("--kill-after", type=int, default=0,
                   help="fire on the Nth request after arming")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default="", help="write stats JSON here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.set_defaults(fn=run_personalize)

    g = sub.add_parser("generate", help="batched prefill + greedy decode")
    g.add_argument("--arch", required=True)
    g.add_argument("--test-mesh", action="store_true",
                   help="run the reduced config")
    g.add_argument("--requests", type=int, default=4)
    g.add_argument("--prompt-len", type=int, default=16)
    g.add_argument("--gen-tokens", type=int, default=16)
    g.add_argument("--sequential-prefill", action="store_true",
                   help="force the per-token prefill (the only one for "
                        "families without a batched prefill)")
    g.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    g.set_defaults(fn=run_generate)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
