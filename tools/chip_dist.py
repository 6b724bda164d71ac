#!/usr/bin/env python3
"""One model trained at full width and depth on four H100s, or
llama3.2-3b's sharded decode over a long cache.

    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py \
        [--arch llama-3.2-vision-11b | zamba2-7b | granite-moe-1b-a400m |
         whisper-tiny | xlstm-1.3b]
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py --decode
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py \
        --device cpu --test-mesh [--arch ... | --decode]   # reduced, gloo

The port's sharded train step (``repro_torch.train.step`` with a mesh) on
the reference's (data, model) = (2, 2) mesh over NCCL, one card per
``LOCAL_RANK``, FSDP by the reference's size rule, fp32 parameters and
AdamW moments, bf16 compute, every cross block's xgate at 0.5.  Global
batch 4 x 4096 tokens, 2 micro-batches, 3 steps.  The default,
llama-3.2-vision-11b: all 40 layers (8 super-blocks of 4 self blocks and
one cross block, each super-block one checkpoint region; the attention
weights split 2 ways over data, the rest 4 ways) against 1600 image
embeddings a sequence; each rank initialises its own blocks layer by
layer from one seed (a whole fp32 copy of the model is 40 GB).
zamba2-7b: all 81 mamba layers (each its own region, replayed with
nothing saved; the SSD scan on each rank's 56 heads) and the shared
block's 13 applications (27 GB of fp32 parameters, drawn whole on each
card from one seed and cut).  granite-moe-1b-a400m (16 of its 32 experts
a rank) and whisper-tiny (3 heads a rank, 1500 frames a sequence) fit on
one card; they run here for their ``--test-mesh`` rehearsals.
xlstm-1.3b: all 48 blocks (each its own region, replayed with nothing
saved; the mLSTM kernel on each rank's 2 heads, every sLSTM recurrence
whole on every rank) at train (f)'s 1024 tokens a sequence.

``--decode``: llama3.2-3b's decode step on (2, 2) (``make_decode_step(...,
mesh=)``, bf16, FSDP by the size rule), 32 sequences over 32,768 cached
positions: 28 x 32 x 32768 x 8 x 128 x 2 x 2 bytes = 120 GB of KV cache,
30 GB a card (each rank its 16 sequences' 4 kv heads), allocated at the
block shapes and filled with seeded normals (the step reads every cached
position whatever its values), then ``DECODE_STEPS`` tokens at lengths
32,760 on.  Rank 0 prints one line per step (step ms, tokens/s, the
collectives of each rank by kind) and a last line with every card's peak.

Rank 0 prints one JSON line per step (loss, step s, tokens/s, the
collectives of each rank by kind from ``launch/comm_analysis.py``) and a
last line with every card's peak, the device idle share of one more step
under ``torch.profiler`` (the share of the wall no kernel covers, NCCL's
counted busy; their time apart) and the card's name and power limit.  Any non-finite loss exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ARCH = "llama-3.2-vision-11b"
ARCHS_RUN = ("llama-3.2-vision-11b", "zamba2-7b", "granite-moe-1b-a400m",
             "whisper-tiny", "xlstm-1.3b")
# --test-mesh: each family reduced (the reference's reduce_config with
# these overrides), every attention through the flash path
TEST_MESH = {
    "llama-3.2-vision-11b": dict(n_layers=4, cross_attn_every=2,
                                 image_tokens=40),
    "zamba2-7b": dict(),
    "granite-moe-1b-a400m": dict(n_layers=2),
    "whisper-tiny": dict(n_heads=6, n_kv_heads=6, encoder_seq=40),
    "xlstm-1.3b": dict(),
}
MESH = (2, 2)
SEQ, BATCH, MICRO, STEPS = 4096, 4, 2, 3
# each arch's sequence where it is not SEQ (xlstm-1.3b: train (f)'s)
ARCH_SEQ = {"xlstm-1.3b": 1024}
XGATE = 0.5
DECODE_ARCH = "llama3.2-3b"
DECODE_BATCH, DECODE_LEN, DECODE_STEPS = 32, 32768, 8


def init_sharded(cfg, shardings, device, seed: int = 0):
    """The vision LM holding only this rank's block of each parameter,
    drawn block by block from ``seed`` (the full-width draws of one
    parameter at a time, then cut)."""
    from repro_torch.models import layers
    from repro_torch.models.multimodal import VisionLM, vlm_layout
    from repro_torch.models.transformer import block_init, padded_vocab
    from repro_torch.sharding.api import mark_sharded

    gen = torch.Generator(device).manual_seed(seed)
    dt = layers.weight_dtype(cfg, True)
    pv, d = padded_vocab(cfg), cfg.d_model
    n_super, per = vlm_layout(cfg)

    def cut(prefix, tree):
        if isinstance(tree, dict):
            return {k: cut(f"{prefix}.{k}", v) for k, v in tree.items()}
        return shardings[prefix].shard(tree).contiguous().clone()

    def block(prefix, cross):
        tree = block_init(gen, cfg, trainable=True, cross=cross)
        if cross:
            tree["xgate"].fill_(XGATE)
        return cut(prefix, tree)

    tree = {"embed": cut("embed", layers.embedding_init(gen, pv, d,
                                                         dtype=dt)),
            "self_blocks": [block(f"self_blocks.{i}", False)
                            for i in range(n_super * per)],
            "cross_blocks": [block(f"cross_blocks.{i}", True)
                             for i in range(n_super)],
            "ln_f": cut("ln_f", layers.rmsnorm_init(d, device=device)),
            "unembed": cut("unembed", layers.dense_init(gen, d, pv,
                                                        dtype=dt))}
    return mark_sharded(VisionLM(cfg, tree, trainable=True), shardings)


def init_whole(model, shardings, device, seed: int = 0):
    """The model drawn whole from ``seed`` on ``device`` (every cross
    gate at ``XGATE``), then cut to this rank's blocks."""
    from repro_torch.sharding.api import shard_module

    params = model.init(seed, device=device, trainable=True)
    for blk in getattr(params, "dec_blocks", ()):
        blk.xgate.data.fill_(XGATE)
    params = shard_module(params, shardings)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return params


def batch_for(cfg, seq: int, step: int, device):
    g = torch.Generator(device).manual_seed(1000 + step)
    tokens = torch.randint(0, cfg.vocab, (BATCH, seq + 1), generator=g,
                           device=device)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "targets": tokens[:, 1:].contiguous()}
    if cfg.family in ("vlm", "audio"):
        key, t = (("image_embeds", cfg.image_tokens) if cfg.family == "vlm"
                  else ("enc_frames", cfg.encoder_seq))
        batch[key] = torch.randn(BATCH, t, cfg.d_model, generator=g,
                                 device=device)
    return batch


def _covered(spans):
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def idle_share(step):
    """(wall s, kernel s, covered s, NCCL s, idle share) of ``step()``
    under the profiler: kernel s sums every kernel's device time over the
    streams (NCCL's included), covered s is the time some kernel runs (the
    union of their intervals: the collectives' stream overlaps the compute
    stream, so the sum can exceed the wall), and the idle share is 1 -
    covered / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = nccl = 0.0
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith("Memcpy") \
                or e.name == "Command Buffer Full":
            continue
        us = e.time_range.end - e.time_range.start
        busy += us
        spans.append((e.time_range.start, e.time_range.end))
        if "nccl" in e.name.lower():
            nccl += us
    covered = _covered(spans) / 1e6
    return wall, busy / 1e6, covered, nccl / 1e6, 1 - covered / wall


def run_decode(args, rank, world, device, on_card, gpu) -> int:
    """``--decode``: the sharded decode step over a long cache."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model, reduce_config
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_decode_step

    cfg, b, length = ARCHS[DECODE_ARCH], DECODE_BATCH, DECODE_LEN
    if args.test_mesh:
        cfg, b, length = reduce_config(cfg), 8, 64
    mesh = make_mesh(MESH, ("data", "model"),
                     device="cuda" if on_card else "cpu")
    model = build_model(cfg)
    bundle = make_decode_step(model, mesh=mesh, shape=ShapeConfig(
        "decode_32k", length, b, "decode"))
    t0 = time.perf_counter()
    params = bundle.shard_params(model.init(0, device=device))
    state = bundle.init_state(device)
    g = torch.Generator(device).manual_seed(100 + rank)
    for leaf in state.values():
        leaf.normal_(generator=g)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    cache_gb = sum(t.numel() * t.element_size() for t in state.values()) / 1e9
    if rank == 0:
        print(json.dumps({"phase": "init", "arch": cfg.name,
                          "layers": cfg.n_layers, "mesh": list(MESH),
                          "batch": b, "cached_positions": length,
                          "kv_cache_gb_per_card": cache_gb,
                          "fsdp": any("data" in sh.used_axes() for sh in
                                      bundle.in_shardings[0].values()),
                          "init_s": time.perf_counter() - t0, "gpu": gpu}),
              flush=True)
    tok = torch.Generator(device).manual_seed(7)
    start = length - DECODE_STEPS
    times = []
    for step in range(DECODE_STEPS):
        batch = {"tokens": torch.randint(0, cfg.vocab, (b,), generator=tok,
                                         device=device),
                 "cache_len": torch.full((b,), start + step, device=device)}
        C.reset_tally()
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        logits, state = bundle(params, state, batch)
        ok = bool(torch.isfinite(logits).all())
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        step_s = time.perf_counter() - t0
        times.append(step_s)
        coll = analyze_collectives()
        per_rank = [None] * world
        dist.all_gather_object(per_rank, coll["per_op"])
        if rank == 0:
            print(json.dumps({"phase": "step", "step": step, "finite": ok,
                              "step_ms": step_s * 1e3,
                              "tokens_per_s": b / step_s,
                              "collective_bytes_rank0":
                                  coll["collective_bytes"],
                              "collectives_by_rank": per_rank}), flush=True)
        if not ok:
            return 1
    out = {"phase": "done", "ok": True,
           "median_step_ms": sorted(times)[len(times) // 2] * 1e3,
           "tokens_per_s_median": b / sorted(times)[len(times) // 2]}
    if on_card:
        peaks = [None] * world
        dist.all_gather_object(
            peaks, torch.cuda.max_memory_allocated(device) / 1e9)
        out.update(peak_gb=peaks, gpu=gpu)
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' rehearses on gloo (default: the cards)")
    ap.add_argument("--test-mesh", action="store_true",
                    help="the reduced config (with --device cpu)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--arch", default=ARCH, choices=ARCHS_RUN)
    ap.add_argument("--decode", action="store_true",
                    help="llama3.2-3b's sharded decode over 32,768 cached "
                         "positions instead of a train step")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model, reduce_config
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_train_step

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    on_card = args.device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            print("chip_dist: no CUDA device", file=sys.stderr)
            return 2
        torch.cuda.set_device(local)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", local) if on_card else torch.device("cpu")
    dist.init_process_group("nccl" if on_card else "gloo",
                            timeout=timedelta(minutes=4))
    try:
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[:1] if on_card else []
        if args.decode:
            return run_decode(args, rank, world, device, on_card, gpu)
        cfg = dataclasses.replace(ARCHS[args.arch], attention_impl="pallas")
        seq = ARCH_SEQ.get(args.arch, SEQ)
        if args.test_mesh:
            cfg = reduce_config(cfg, block_q=32, block_kv=32,
                                attention_impl="pallas", remat=True,
                                **TEST_MESH[args.arch])
            seq = 48
        mesh = make_mesh(MESH, ("data", "model"),
                         device="cuda" if on_card else "cpu")
        model = build_model(cfg)
        shape = ShapeConfig("train_4k", seq, BATCH, "train")
        bundle = make_train_step(model, make_optimizer("adamw"), shape,
                                 mesh=mesh, microbatches=MICRO)
        t0 = time.perf_counter()
        if cfg.family == "vlm":
            params = init_sharded(cfg, bundle.in_shardings[0], device)
        else:
            params = init_whole(model, bundle.in_shardings[0], device)
        state = bundle.init_state(params)
        init_s = time.perf_counter() - t0
        if rank == 0:
            print(json.dumps({"phase": "init", "arch": cfg.name,
                              "layers": cfg.n_layers, "mesh": list(MESH),
                              "fsdp": any("data" in sh.used_axes() for sh in
                                          bundle.in_shardings[0].values()),
                              "init_s": init_s, "gpu": gpu}), flush=True)
        losses = []
        for step in range(args.steps):
            batch = batch_for(cfg, seq, step, device)
            C.reset_tally()
            if on_card:
                torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            _, _, metrics = bundle(params, state, batch)
            loss = float(metrics["loss"])
            dist.barrier()
            step_s = time.perf_counter() - t0
            coll = analyze_collectives()
            per_rank = [None] * world
            dist.all_gather_object(per_rank, coll["per_op"])
            losses.append(loss)
            if rank == 0:
                print(json.dumps({
                    "phase": "step", "step": step, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "step_s": step_s, "tokens_per_s": BATCH * seq / step_s,
                    "collective_bytes_rank0": coll["collective_bytes"],
                    "collectives_by_rank": per_rank}), flush=True)
        out = {"phase": "done", "ok": all(map(math.isfinite, losses)),
               "losses": losses}
        if on_card:
            batch = batch_for(cfg, seq, args.steps, device)
            wall, busy, covered, nccl, idle = idle_share(
                lambda: bundle(params, state, batch))
            peaks = [None] * world
            dist.all_gather_object(
                peaks, torch.cuda.max_memory_allocated(device) / 1e9)
            out.update(profiled_step_s=wall, device_kernel_s=busy,
                       device_covered_s=covered, nccl_s=nccl,
                       device_idle_share=idle, peak_gb=peaks, gpu=gpu)
        if rank == 0:
            print(json.dumps(out), flush=True)
        return 0 if out["ok"] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
