#!/usr/bin/env python3
"""Wall time of the PyTorch port's personalize service on one CUDA card.

    python3 tools/time_personalize.py [--case a|b|both] [--rounds 7]
                                      [--deterministic] [--src DIR]

Builds the service twice, interleaved and FIFO, on the same traffic as
``chip_smoke.py``'s ``personalize`` phase: (a) resnet18_transfer, 8 users
over buckets (8, 16), the swap-forcing plan config, the ``async`` backend;
(b) resnet18 fully trainable, 4 users over (64, 128), optimizer state
offloaded, lr 1e-3.  After one warm-up wave each, it drains ``--rounds``
waves of one request per user with the two services in turns and prints
one JSON line per case: the median wave wall (host clock, after the
card's work) and the steps/s it gives, per mode.

``--src`` imports ``repro_torch`` from another checkout's ``src``, so two
trees of the port are timed in one call on one card (run them in the
order parent, change, change, parent).  ``--deterministic`` runs the
whole process under cuDNN's deterministic algorithms, as a service that
does not set them itself would run inside ``chip_smoke.py``.  Needs the
card; it raises without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "a": dict(graph="resnet18_transfer", buckets=(8, 16), users=8,
              sizes=(14, 6), lr=0.05, swap_forcing=True, offload=False),
    "b": dict(graph="resnet18", buckets=(64, 128), users=4,
              sizes=(128, 40), lr=1e-3, swap_forcing=False, offload=True),
}


def time_case(torch, case: dict, rounds: int) -> dict:
    from repro_torch.core.plan import MemoryPlanConfig
    from repro_torch.core.zoo import ZOO
    from repro_torch.serve import PersonalizationService
    from repro_torch.serve.buckets import dummy_batch

    g = ZOO[case["graph"]]()
    extra = dict(min_idle_phases=3, min_bytes=1 << 12) \
        if case["swap_forcing"] else {}
    config = MemoryPlanConfig(executor="async",
                              optim_offload=case["offload"], **extra)
    svcs = {mode: PersonalizationService(
        g, buckets=case["buckets"], max_live_sessions=case["users"],
        config=config, interleave=mode, lr=case["lr"], device="cuda")
        for mode in (True, False)}
    batches = [dummy_batch(g, case["sizes"][u % 2], seed=1000 + u,
                           device="cuda") for u in range(case["users"])]
    walls = {mode: [] for mode in svcs}
    for r in range(rounds + 1):
        for mode, svc in svcs.items():
            for u, (x, y) in enumerate(batches):
                svc.enqueue(f"u{u}", x, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = svc.drain()
            torch.cuda.synchronize()
            if r:                          # round 0 warms up
                walls[mode].append(time.perf_counter() - t0)
            bad = [(res.user, res.status) for res in results if not res.ok]
            if bad:
                raise RuntimeError(f"interleave={mode}: {bad}")
    med = {mode: statistics.median(w) for mode, w in walls.items()}
    return {"graph": case["graph"], "users": case["users"],
            "rounds": rounds,
            "interleaved_wave_s": med[True], "fifo_wave_s": med[False],
            "interleaved_steps_per_s": case["users"] / med[True],
            "fifo_steps_per_s": case["users"] / med[False],
            "interleaved_wave_s_all": walls[True],
            "fifo_wave_s_all": walls[False]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=["a", "b", "both"], default="both")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_personalize: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = args.deterministic
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for name in ("a", "b") if args.case == "both" else (args.case,):
        row = time_case(torch, CASES[name], args.rounds)
        print(json.dumps({"case": name, "src": args.src,
                          "deterministic": args.deterministic,
                          "gpu": gpu.splitlines()[0], **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
