"""Serving launcher: LM generation (batched prefill + greedy decode).

Port of the ``generate`` subcommand of ``repro/launch/serve.py``::

    python -m repro_torch.launch.serve generate --arch llama3.2-3b \
        --requests 4 --prompt-len 512 --gen-tokens 16

Requests are batched, prefilled with one fused full-prompt forward that
fills the KV cache (``model.prefill_fn``; ``--sequential-prefill`` forces
the per-token cache fill instead), then decoded token by token with greedy
sampling.  Weights are random from seed 0.  It runs on the CUDA card;
``--device cpu`` runs the plain PyTorch path on the host.  ``--test-mesh``
keeps its reference meaning: the reduced config.  The ``personalize``
subcommand comes with the next slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

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


@torch.no_grad()
def generate(model: Model, params, prompts: torch.Tensor, gen_tokens: int,
             *, sequential_prefill: bool = False) -> Generation:
    """Prefill ``prompts`` (B, P) into a fresh KV cache, then greedy-decode
    ``gen_tokens`` tokens.  Times are host clock around work that ends in a
    device synchronise."""
    cfg = model.cfg
    dev = prompts.device
    b, plen = prompts.shape
    decode = make_decode_step(model)
    state = model.decode_init(b, plen + gen_tokens + 8, device=dev)

    def lengths(n):
        return torch.full((b,), n, dtype=torch.int32, device=dev)

    synchronize(dev)
    t0 = time.perf_counter()
    if sequential_prefill:
        for t in range(plen):
            logits, state = decode(params, state, {
                "tokens": prompts[:, t], "cache_len": lengths(t)})
        mode = "sequential"
    else:
        logits, state = model.prefill_fn(params, state, prompts)
        mode = "batched"
    synchronize(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    cur = logits[:, :cfg.vocab].argmax(dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        out.append(cur)
        logits, state = decode(params, state, {
            "tokens": cur, "cache_len": lengths(plen + i)})
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
                   help="force the per-token fallback prefill")
    g.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    g.set_defaults(fn=run_generate)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
