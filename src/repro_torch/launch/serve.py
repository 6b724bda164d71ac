"""Serving launcher: LM generation (batched prefill + greedy decode).

Port of the ``generate`` subcommand of ``repro/launch/serve.py``::

    python -m repro_torch.launch.serve generate --arch llama3.2-3b \
        --requests 4 --prompt-len 512 --gen-tokens 16

Requests are batched, prefilled with one fused full-prompt forward that
fills the KV cache (``model.prefill_fn``; the dense and MoE families, e.g.
``--arch granite-moe-1b-a400m``), then decoded token by token with greedy
sampling.  A family with no ``prefill_fn`` (the hybrid and
the xLSTM, whose states are recurrent) fills its state token by token
through the decode step, as ``--sequential-prefill`` forces for any
family: ``--arch zamba2-7b`` and ``--arch xlstm-1.3b`` serve so.  Weights are
random from seed 0.  It runs on the CUDA card; ``--device cpu`` runs the
plain PyTorch path on the host.  ``--test-mesh`` keeps its reference
meaning: the reduced config.  The ``personalize`` subcommand comes with
a later slice of the port (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.models.model import Model
from repro_torch.train.step import make_decode_step


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
