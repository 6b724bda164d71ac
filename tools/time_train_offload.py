#!/usr/bin/env python3
"""Train-step time of llama3.2-3b with and without offloaded activations,
in turns on one CUDA card.

    python3 tools/time_train_offload.py [--rounds 5] [--device cpu --reduced]

Two train steps (``make_train_step``: 2 sequences of 4096 in 2
micro-batches, AdamW with fp32 state, random weights from seed 0, bf16
compute, ``attention_impl="pallas"``) over one set of parameters and
optimizer state, at full width and depth: the default plan, which keeps
every tag on the card, and the plan of ``chip_smoke.py``'s ``train`` (b),
which offloads ``mlp_hidden`` to pinned host memory (a 100 MB per-layer
budget and DMA priced at 10 TB/s: at the default 32 GB/s the plan
recomputes every eviction).  After one warm-up step each, ``--rounds``
rounds run one step of each, the order alternating from round to round.
Prints one JSON line: each plan's step times (host clock, after the
card's work) and their median, and for the offloading plan the time the
compute stream waited for fetched copies in each step
(``remat.fence_wait_ms``).  ``--device cpu --reduced`` runs the reduced
config at S = 64 on the host, to try the script (no copy stream there,
so no fence waits).  Without ``--device`` it needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import remat  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

OFFLOAD_BUDGET, OFFLOAD_DMA_GBPS = 100_000_000, 1e4   # chip_smoke.py (b)
BATCH, MICRO = 2, 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default=None)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"], attention_impl="pallas")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=BATCH)
    budget = OFFLOAD_BUDGET
    if args.reduced:
        cfg = reduce_config(cfg, remat=True, block_q=32, block_kv=32)
        shape = dataclasses.replace(shape, seq_len=64)
        budget = 64 * cfg.d_model * 2 * 4
    plans = {"keep": cfg,
             "offload": dataclasses.replace(cfg, offload=True,
                                            remat_budget_bytes=budget,
                                            dma_gbps=OFFLOAD_DMA_GBPS)}
    opt = make_optimizer("adamw")
    params = build_model(cfg).init(0, device=device, trainable=True)
    state = opt.init(dict(params.named_parameters()))
    steps = {name: make_train_step(build_model(c), opt, shape,
                                   microbatches=MICRO)
             for name, c in plans.items()}
    decisions = steps["offload"].memory_plan.remat_plan.decisions()
    g = torch.Generator(device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab, (BATCH, shape.seq_len + 1),
                         generator=g, device=device)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    times = {name: [] for name in plans}
    fence_ms = []

    def step(name):
        synchronize(device)
        t0 = time.perf_counter()
        with remat.observe_regions() as stats:
            steps[name].fn(params, state, batch)
        synchronize(device)
        return time.perf_counter() - t0, stats

    for name in plans:                                  # warm-up
        step(name)
    for r in range(args.rounds):
        order = list(plans) if r % 2 == 0 else list(plans)[::-1]
        for name in order:
            dt, stats = step(name)
            times[name].append(dt)
            if name == "offload":
                fence_ms.append(remat.fence_wait_ms(stats))

    gpu = None
    if device.type == "cuda":
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "gpu": gpu, "layers": cfg.n_layers, "seq": shape.seq_len,
        "batch": BATCH, "microbatches": MICRO, "rounds": args.rounds,
        "offload_decisions": decisions,
        "step_s": times,
        "median_s": {k: statistics.median(v) for k, v in times.items()},
        "offload_over_keep": statistics.median(times["offload"])
        / statistics.median(times["keep"]),
        "fence_wait_ms_per_step": fence_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
