#!/usr/bin/env python3
"""One model trained at full width and depth on four H100s, or
llama3.2-3b's sharded decode over a long cache.

    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py \
        [--arch llama-3.2-vision-11b | zamba2-7b | granite-moe-1b-a400m |
         whisper-tiny | xlstm-1.3b]
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py \
        --arch llama-3.2-vision-11b --optimizer adamw_int8
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py --decode
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py --decode \
        --arch zamba2-7b --shape long_500k
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py --allreduce
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py --suite
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py --multi-pod
    torchrun --standalone --nproc-per-node 4 tools/chip_dist.py \
        --device cpu --test-mesh [--arch ... | --decode ... | --suite |
        --multi-pod]

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

``--optimizer adamw_int8`` trains with the reference's int8 AdamW
moments (blocks of 256 of each flat parameter over (data, model),
``train/step.py``) instead of fp32 ones.

``--decode``: llama3.2-3b's decode step on (2, 2) (``make_decode_step(...,
mesh=)``, bf16, FSDP by the size rule), 32 sequences over 32,768 cached
positions: 28 x 32 x 32768 x 8 x 128 x 2 x 2 bytes = 120 GB of KV cache,
30 GB a card (each rank its 16 sequences' 4 kv heads), allocated at the
block shapes and filled with seeded normals (the step reads every cached
position whatever its values), then ``DECODE_STEPS`` tokens at lengths
32,760 on.  ``--decode --arch zamba2-7b --shape long_500k``: all 81
layers, one sequence over 524,288 cached positions: 13 x 524288 x 32 x
112 x 2 x 2 bytes = 97.7 GB of KV cache, 24.4 GB a card (the batch does
not split, so the reference's rules put the positions over ``data``, the
kv heads over ``model``), filled so, then ``DECODE_STEPS`` tokens at
lengths 524,280 on.  Rank 0 prints one line per step (step ms, tokens/s,
the collectives of each rank by kind), the fused SwiGLU kernel's row at
the steps' per-rank shape (its launches in the uncounted steps, its
time against its plain twin's and ``matmul(x, [Wg | Wu])``'s and its
bound) and a last line with every card's peak.

``--allreduce``: an NCCL all-reduce of ``ALLREDUCE_BYTES`` (1 GiB of
fp32) over the four cards, the median of ``ALLREDUCE_REPS`` timed calls,
its bus bandwidth (bytes x 2 (n - 1) / n over the time) beside the data
sheet's NVLink rate of one direction (``launch/hw.py``, 450 GB/s).
``--suite`` runs the all-reduce, the zamba2-7b ``long_500k`` decode and
the vision LM's int8 train step in turn, in one process group.

``--multi-pod``: llama3.2-3b's train step (``train_4k`` rows: 4
sequences of 4096, fp32 parameters and AdamW moments, FSDP by the size
rule) on the reference's multi-pod mesh at four ranks, (pod, data,
model) = (2, 1, 2) and (2, 2, 1), each held against the (data, model) =
(2, 2) step of the same batch from the same parameters in the same
world: at ``POD_FP32_DEPTH`` layers in fp32 (each gradient leaf
normwise within 1e-4, the loss within 1e-4) and at full depth in bf16.
First one fp32 step at full depth on (2, 2); each bf16 row prints its
whole gradient's normwise distance from that one (``fp32_rel``), and a
pod mesh's must stay within 1.25 times (2, 2)'s own (the loss within
2e-2 of (2, 2)'s): two correct bf16 roundings of the step part by about
that distance, so the bf16 rows' distance from each other (``grad_rel``,
printed) is not gated.
Each micro-batch gives every batch rank one sequence.  Per mesh rank 0
prints the step seconds, every card's peak, the collectives by kind and
by axis (one step's records), the flash and SwiGLU launches by variant,
and the ``pod`` axis's bytes a rank beside their reckoning (every
gradient block the pod all-reduce sums, and the loss and norm scalars).

Every run's last step is counted by the cost probe's counters
(``probe.counting``, the kernels' terms added: ``dryrun.mesh_probe``),
and rank 0 prints its roofline row with the collective term
(``launch/roofline.py``).

Rank 0 prints one JSON line per step (loss, step s, tokens/s, the
collectives of each rank by kind from ``launch/comm_analysis.py``) and a
last line with every card's peak, the device idle share of one more step
under ``torch.profiler`` (the share of the wall no kernel covers, NCCL's
counted busy; their time apart) and the card's name and power limit.  Any non-finite loss exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
             "whisper-tiny", "xlstm-1.3b", "llama3.2-3b")
# --test-mesh: each family reduced (the reference's reduce_config with
# these overrides), every attention through the flash path
TEST_MESH = {
    "llama-3.2-vision-11b": dict(n_layers=4, cross_attn_every=2,
                                 image_tokens=40),
    "zamba2-7b": dict(),
    "granite-moe-1b-a400m": dict(n_layers=2),
    "whisper-tiny": dict(n_heads=6, n_kv_heads=6, encoder_seq=40),
    "xlstm-1.3b": dict(),
    "llama3.2-3b": dict(),
}
MESH = (2, 2)
SEQ, BATCH, MICRO, STEPS = 4096, 4, 2, 3
# each arch's sequence where it is not SEQ (xlstm-1.3b: train (f)'s)
ARCH_SEQ = {"xlstm-1.3b": 1024}
XGATE = 0.5
DECODE_ARCH = "llama3.2-3b"
DECODE_BATCH, DECODE_LEN, DECODE_STEPS = 32, 32768, 8
ALLREDUCE_BYTES, ALLREDUCE_REPS = 1 << 30, 10
# --suite: (mode, arch, shape or optimizer) in turn
SUITE = (("allreduce", None, None),
         ("decode", "zamba2-7b", "long_500k"),
         ("train", "llama-3.2-vision-11b", "adamw_int8"))
# --multi-pod: the reference (data, model) mesh first, then the pod meshes
POD_ARCH = "llama3.2-3b"
POD_MESHES = (((2, 2), ("data", "model")),
              ((2, 1, 2), ("pod", "data", "model")),
              ((2, 2, 1), ("pod", "data", "model")))
POD_FP32_DEPTH = 4
# (dtype, layers (None: all), gate, meshes).  fp32: the loss and each
# gradient leaf normwise from (2, 2)'s within the gate.  bf16: the loss
# from (2, 2)'s within POD_BF16_LOSS_TOL, and the whole gradient's
# normwise distance from the fp32 gradient at full depth within the gate
# times (2, 2)'s own distance from it (two correct bf16 roundings of the
# step part by about that distance: (2, 2, 1) sums its batch in one
# micro-batch, (2, 2) in two).  Gate None: that fp32 gradient.
POD_BF16_LOSS_TOL = 2e-2
POD_RUNS = (("float32", None, None, POD_MESHES[:1]),
            ("bfloat16", None, 1.25, POD_MESHES),
            ("float32", POD_FP32_DEPTH, 1e-4, POD_MESHES))


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


def roofline_row(cfg, shape, mesh, counters, collective_bytes, on_card,
                 step_s):
    """The roofline row of a counted step: a rank's FLOPs and bytes
    (``dryrun.mesh_probe``), its collective bytes, ``step_s``."""
    from repro_torch.launch.dryrun import mesh_probe
    from repro_torch.launch.roofline import analyze, matmul_params

    probe = mesh_probe(cfg, shape, mesh, *counters, on_card)
    row = analyze(cfg.name, shape, probe["flops"], probe["bytes"],
                  n_params=matmul_params(cfg),
                  collective_bytes=collective_bytes,
                  chips=math.prod(mesh.shape.values()), step_s=step_s)
    return {"phase": "roofline", **row, "kernel_share":
            probe["kernel_share"]}


def run_allreduce(rank, world, device, on_card, gpu, test_mesh) -> int:
    """``--allreduce``: the bus bandwidth of an all-reduce of
    ``ALLREDUCE_BYTES`` over the world."""
    from repro_torch.launch import hw

    n = (ALLREDUCE_BYTES if not test_mesh else 1 << 20) // 4
    buf = torch.ones(n, device=device)
    dist.all_reduce(buf)                      # warm up (NCCL's rings)
    times = []
    for _ in range(ALLREDUCE_REPS):
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ok = bool(torch.isfinite(buf).all())
    t = sorted(times)[len(times) // 2]
    nbytes = n * 4
    if rank == 0:
        print(json.dumps({
            "phase": "allreduce", "ok": ok, "bytes": nbytes, "ranks": world,
            "median_s": t, "times_s": times, "algbw_bytes_per_s": nbytes / t,
            "busbw_bytes_per_s": nbytes / t * 2 * (world - 1) / world,
            "nvlink_one_direction_bytes_per_s": hw.LINK_BYTES_PER_S,
            "gpu": gpu}), flush=True)
    del buf
    return 0 if ok else 1


def _fill_normal(tree, g):
    for leaf in (tree.values() if isinstance(tree, dict) else [tree]):
        if isinstance(leaf, dict):
            _fill_normal(leaf, g)
        else:
            leaf.normal_(generator=g)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@contextlib.contextmanager
def _swiglu_launches(into: list):
    """Append (m, k, f) of every fused SwiGLU kernel launch in the body
    (its wrapper calls the module's ``_launch``) to ``into``; the expert
    form as (e, m, k, f)."""
    from repro_torch.kernels.fused_swiglu import kernel as sw
    launch = sw._launch

    def recorded(x, wg, wu, variant):
        into.append(tuple(x.shape) + (wg.shape[-1],))
        return launch(x, wg, wu, variant)

    sw._launch = recorded
    try:
        yield into
    finally:
        sw._launch = launch


def _median_ms_in_turns(fns, reps: int = 50):
    """The median CUDA-event time (ms) of each of ``fns``, called in turns
    after 3 warm-up rounds."""
    for _ in range(3):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
    return [sorted(ts)[len(ts) // 2] for ts in times]


def swiglu_row(call, launches: int, steps: int, gpu) -> dict:
    """The fused SwiGLU kernel at a decode step's per-rank shape ``call``
    ((m, k, f), dense), bf16 on seeded inputs: the kernel the wrapper
    chooses against its plain twin (largest error), and the times of the
    kernel, the twin and ``matmul(x, [Wg | Wu])`` in turns; the bound is
    the larger of the bytes over HBM and the flops over the bf16 peak
    (``launch/costs.py``, ``launch/hw.py``); ``launches``, the four
    ranks' over ``steps`` uncounted steps."""
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.launch import costs, hw
    if len(call) != 3:
        return {"phase": "swiglu", "skipped": f"expert form {call}"}
    m, k, f = call
    g = torch.Generator("cuda").manual_seed(321)
    x = (torch.randn(m, k, generator=g, device="cuda") * 0.5).bfloat16()
    wg, wu = ((torch.randn(k, f, generator=g, device="cuda") * 0.05)
              .bfloat16() for _ in range(2))
    out = sw.fused_swiglu(x, wg, wu)
    err = (out.float() - sw.fused_swiglu_plain(x, wg, wu).float()
           ).abs().max().item()
    w_cat = torch.cat([wg, wu], dim=-1)
    ms, plain_ms, library_ms = _median_ms_in_turns([
        lambda: sw.fused_swiglu(x, wg, wu),
        lambda: sw.fused_swiglu_plain(x, wg, wu),
        lambda: torch.matmul(x, w_cat)])
    flops, nbytes = costs.swiglu_launch((1, m, k, f), "bfloat16")
    bound_ms, bound_by = hw.bound_ms(flops, nbytes, "bfloat16")
    return {"phase": "swiglu", "shape": {"m": m, "k": k, "f": f},
            "variant": sw.variant_for(x, wg, wu), "launches": launches,
            "steps": steps, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_note": "torch.matmul(x, [Wg | Wu]): the two products "
                            "only, no epilogue",
            "bound_ms": bound_ms, "bound_by": bound_by, "gpu": gpu}


def run_decode(args, rank, world, device, on_card, gpu) -> int:
    """``--decode``: the sharded decode step over a long cache
    (llama3.2-3b's 32 sequences, or ``--shape long_500k``'s one)."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.probe import counting
    from repro_torch.models.model import build_model, reduce_config
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_decode_step

    arch = args.arch or DECODE_ARCH
    cfg = ARCHS[arch]
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeConfig("decode_32k", DECODE_LEN, DECODE_BATCH, "decode")
    if args.test_mesh:
        cfg = reduce_config(cfg)
        shape = dataclasses.replace(
            shape, seq_len=64, global_batch=min(shape.global_batch, 8))
    b, length = shape.global_batch, shape.seq_len
    mesh = make_mesh(MESH, ("data", "model"),
                     device="cuda" if on_card else "cpu")
    model = build_model(cfg)
    bundle = make_decode_step(model, mesh=mesh, shape=shape)
    t0 = time.perf_counter()
    params = bundle.shard_params(model.init(0, device=device))
    if on_card:
        torch.cuda.empty_cache()
    state = bundle.init_state(device)
    g = torch.Generator(device).manual_seed(100 + rank)
    _fill_normal(state, g)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(state)) / 1e9
    cache = state["attn"] if "attn" in state else state
    cache_gb = sum(t.numel() * t.element_size()
                   for t in (cache["k"], cache["v"])) / 1e9
    if rank == 0:
        print(json.dumps({"phase": "init", "arch": cfg.name,
                          "shape": shape.name, "layers": cfg.n_layers,
                          "mesh": list(MESH), "batch": b,
                          "cached_positions": length,
                          "batch_splits": bundle.act_rules["batch"]
                          is not None,
                          "kv_cache_spec": list(map(str, bundle.in_shardings[
                              1]["attn"]["k"].spec if "attn" in state
                              else bundle.in_shardings[1]["k"].spec)),
                          "kv_cache_gb_per_card": cache_gb,
                          "state_gb_per_card": state_gb,
                          "fsdp": any("data" in sh.used_axes() for sh in
                                      bundle.in_shardings[0].values()),
                          "init_s": time.perf_counter() - t0, "gpu": gpu}),
              flush=True)
    tok = torch.Generator(device).manual_seed(7)
    start = length - DECODE_STEPS
    times = []
    swiglu_calls = []
    for step in range(DECODE_STEPS):
        batch = {"tokens": torch.randint(0, cfg.vocab, (b,), generator=tok,
                                         device=device),
                 "cache_len": torch.full((b,), start + step, device=device)}
        C.reset_tally()
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        last = step == DECODE_STEPS - 1
        t0 = time.perf_counter()
        with counting() if last else contextlib.nullcontext((None, None)) \
                as counters, _swiglu_launches(
                    swiglu_calls if not last else []):
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
                              "counted": last, "step_ms": step_s * 1e3,
                              "tokens_per_s": b / step_s,
                              "collective_bytes_rank0":
                                  coll["collective_bytes"],
                              "collectives_by_rank": per_rank}), flush=True)
            if last:
                warm = times[1:-1] or times
                print(json.dumps(roofline_row(
                    cfg, shape, mesh, counters, coll["collective_bytes"],
                    on_card, sorted(warm)[len(warm) // 2])), flush=True)
        if not ok:
            return 1
    launches = [None] * world
    dist.all_gather_object(launches, len(swiglu_calls))
    out = {"phase": "done", "ok": True, "arch": cfg.name,
           "shape": shape.name,
           "median_step_ms": sorted(times)[len(times) // 2] * 1e3,
           "tokens_per_s_median": b / sorted(times)[len(times) // 2],
           "swiglu_launches_by_rank": launches}
    if on_card and swiglu_calls:
        row = swiglu_row(max(set(swiglu_calls), key=swiglu_calls.count),
                         sum(launches), DECODE_STEPS - 1, gpu)
        if rank == 0:
            print(json.dumps(row), flush=True)
    if on_card:
        peaks = [None] * world
        dist.all_gather_object(
            peaks, torch.cuda.max_memory_allocated(device) / 1e9)
        out.update(peak_gb=peaks, gpu=gpu)
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def run_train(args, rank, world, device, on_card, gpu) -> int:
    """The sharded train step of ``args.arch`` (``--optimizer``'s
    moments)."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.probe import counting
    from repro_torch.models.model import build_model, reduce_config
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_train_step

    arch = args.arch or ARCH
    cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas")
    seq = ARCH_SEQ.get(arch, SEQ)
    if args.test_mesh:
        cfg = reduce_config(cfg, block_q=32, block_kv=32,
                            attention_impl="pallas", remat=True,
                            **TEST_MESH[arch])
        seq = 48
    mesh = make_mesh(MESH, ("data", "model"),
                     device="cuda" if on_card else "cpu")
    model = build_model(cfg)
    shape = ShapeConfig("train_4k", seq, BATCH, "train")
    state_dtype = {"adamw": "float32", "adamw_int8": "int8"}[args.optimizer]
    bundle = make_train_step(model, make_optimizer(
        "adamw", state_dtype=state_dtype), shape, mesh=mesh,
        microbatches=MICRO)
    t0 = time.perf_counter()
    if cfg.family == "vlm":
        params = init_sharded(cfg, bundle.in_shardings[0], device)
    else:
        params = init_whole(model, bundle.in_shardings[0], device)
    state = bundle.init_state(params)
    init_s = time.perf_counter() - t0
    moments_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(state["mu"])) / 1e9
    if rank == 0:
        print(json.dumps({"phase": "init", "arch": cfg.name,
                          "layers": cfg.n_layers, "mesh": list(MESH),
                          "optimizer": args.optimizer,
                          "moments_gb_rank0": moments_gb,
                          "fsdp": any("data" in sh.used_axes() for sh in
                                      bundle.in_shardings[0].values()),
                          "init_s": init_s, "gpu": gpu}), flush=True)
    losses, times = [], []
    for step in range(args.steps):
        batch = batch_for(cfg, seq, step, device)
        C.reset_tally()
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()
        last = step == args.steps - 1
        t0 = time.perf_counter()
        with counting() if last else contextlib.nullcontext((None, None)) \
                as counters:
            _, _, metrics = bundle(params, state, batch)
            loss = float(metrics["loss"])
        dist.barrier()
        step_s = time.perf_counter() - t0
        coll = analyze_collectives()
        per_rank = [None] * world
        dist.all_gather_object(per_rank, coll["per_op"])
        losses.append(loss)
        if not last:
            times.append(step_s)
        if rank == 0:
            print(json.dumps({
                "phase": "step", "step": step, "loss": loss,
                "grad_norm": float(metrics["grad_norm"]),
                "counted": last,
                "step_s": step_s, "tokens_per_s": BATCH * seq / step_s,
                "collective_bytes_rank0": coll["collective_bytes"],
                "collectives_by_rank": per_rank}), flush=True)
            if last:
                # the step time of the uncounted steps after the first
                warm = times[1:] or times or [step_s]
                print(json.dumps(roofline_row(
                    cfg, shape, mesh, counters, coll["collective_bytes"],
                    on_card, sorted(warm)[len(warm) // 2])), flush=True)
    out = {"phase": "done", "ok": all(map(math.isfinite, losses)),
           "arch": cfg.name, "optimizer": args.optimizer, "losses": losses}
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


def _pod_grads(into: dict, base):
    """``base`` whose update first hands ``into["fn"]`` each gradient
    block it is given (after every reduction), gathered whole on every
    rank by ``into["shardings"]``, one leaf at a time, while
    ``into["on"]`` is set."""
    from repro_torch.sharding import collectives as C

    def update_(grads, state, params, *rest):
        if into.get("on"):
            for n, g in grads.items():
                into["fn"](n, C.gather_global(g, into["shardings"][n]))
        base.update_(grads, state, params, *rest)

    return dataclasses.replace(base, update_=update_)


def run_multipod(args, rank, world, device, on_card, gpu) -> int:
    """``--multi-pod``: llama3.2-3b's train step on (2, 1, 2) and (2, 2,
    1) against (2, 2), in each of ``POD_RUNS``."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build_model, reduce_config
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import make_train_step

    ok = True
    fp32_full = {}          # the full-depth fp32 gradient, on rank 0's host
    for dtype, depth, gate, meshes in POD_RUNS:
        cfg = dataclasses.replace(ARCHS[POD_ARCH], attention_impl="pallas",
                                  dtype=dtype)
        seq = SEQ
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if args.test_mesh:
            cfg = reduce_config(cfg, block_q=32, block_kv=32,
                                attention_impl="pallas")
            seq = 48
        shape = ShapeConfig("train_4k", seq, BATCH, "train")
        # (2, 2)'s gradients, on rank 0's host (the fp32 reference's into
        # fp32_full)
        ref = fp32_full if gate is None else {}
        for mesh_shape, axes in meshes:
            mesh = make_mesh(mesh_shape, axes,
                             device="cuda" if on_card else "cpu")
            key = "x".join(map(str, mesh_shape))
            batch_ranks = math.prod(mesh.shape[a] for a in ("pod", "data")
                                    if a in mesh.shape)
            micro = BATCH // batch_ranks
            model = build_model(cfg)
            hook = {}
            bundle = make_train_step(
                model, _pod_grads(hook, make_optimizer("adamw")), shape,
                mesh=mesh, microbatches=micro)
            # the gradient blocks the update is given are the moments'
            m_shard = {n: v["m"] for n, v in
                       bundle.in_shardings[1]["mu"].items()}
            hook["shardings"] = m_shard
            params = init_whole(model, bundle.in_shardings[0], device)
            state = bundle.init_state(params)
            reckoned = 4 * sum(math.prod(sh.shard_shape(s)) for sh, s in
                               ((m_shard[n], model.param_shapes()[n])
                                for n in m_shard)) + 8
            errs = {"leaf_max": 0.0, "leaf": None, "diff": 0.0, "ref": 0.0,
                    "fp32_diff": 0.0, "fp32_ref": 0.0}

            def keep(n, g):
                if rank != 0:
                    return
                if fp32_full.get("done") and depth is None:
                    want = fp32_full[n].to(g.device)
                    errs["fp32_diff"] = max(errs["fp32_diff"], (
                        g.float() - want).abs().max().item())
                    errs["fp32_ref"] = max(errs["fp32_ref"],
                                           want.abs().max().item())
                if not ref.get("done"):
                    ref[n] = g.float().cpu()
                    return
                want = ref[n].to(g.device)
                d = (g.float() - want).abs().max().item()
                m = want.abs().max().item()
                rel = d / max(m, 1e-30)
                if rel > errs["leaf_max"]:
                    errs["leaf_max"], errs["leaf"] = rel, n
                errs["diff"] = max(errs["diff"], d)
                errs["ref"] = max(errs["ref"], m)

            hook["fn"] = keep
            losses, times, calls = [], [], []
            fa.reset_launches()
            sw.reset_launches()
            for step in range(args.steps if gate is not None else 1):
                batch = batch_for(cfg, seq, step, device)
                hook["on"] = step == 0
                last = step == args.steps - 1
                C.reset_tally()
                if on_card:
                    torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                with C.record_calls() if last else \
                        contextlib.nullcontext([]) as found:
                    _, _, metrics = bundle(params, state, batch)
                    losses.append(float(metrics["loss"]))
                dist.barrier()
                step_s = time.perf_counter() - t0
                if step > 0:
                    times.append(step_s)
                if last:
                    calls = found
            coll = analyze_collectives(calls=calls)
            pod_bytes = [None] * world
            dist.all_gather_object(pod_bytes, sum(
                d["operand_bytes"] for axis, kinds in coll["per_axis"].items()
                if "pod" in axis.split("+") for d in kinds.values()))
            peaks = [None] * world
            dist.all_gather_object(
                peaks, torch.cuda.max_memory_allocated(device) / 1e9
                if on_card else None)
            row = {"phase": "multipod", "dtype": dtype,
                   "layers": cfg.n_layers, "mesh": list(mesh_shape),
                   "axes": list(axes), "microbatches": micro,
                   "batch": BATCH, "seq": seq, "losses": losses,
                   "step_s": times,
                   "median_step_s": sorted(times)[len(times) // 2]
                   if times else None,
                   "collectives_by_kind": coll["per_op"],
                   "collectives_by_axis": coll["per_axis"],
                   "collective_bytes": coll["collective_bytes"],
                   "pod_axis_bytes_by_rank": pod_bytes,
                   "pod_axis_bytes_reckoned": reckoned
                   if "pod" in mesh.shape else 0,
                   "flash_launches": dict(fa.LAUNCHES_BY_VARIANT),
                   "swiglu_launches": dict(sw.LAUNCHES_BY_VARIANT),
                   "peak_gb": peaks, "gpu": gpu}
            if rank == 0:
                if errs["fp32_ref"]:
                    row["fp32_rel"] = errs["fp32_diff"] / errs["fp32_ref"]
                if not ref.get("done"):
                    ref["done"], ref["loss"] = True, losses[0]
                    ref["fp32_rel"] = row.get("fp32_rel")
                    row["reference"] = "fp32 gradient at full depth" \
                        if gate is None else "the (2, 2) step"
                else:
                    loss_rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
                    if dtype == "bfloat16":
                        grad_rel = errs["diff"] / max(errs["ref"], 1e-30)
                        passed = loss_rel <= POD_BF16_LOSS_TOL and \
                            row["fp32_rel"] <= gate * ref["fp32_rel"]
                        row.update(
                            grad_gate="whole gradient normwise from the "
                                      "fp32 one, within gate x (2, 2)'s",
                            fp32_rel_2x2=ref["fp32_rel"],
                            loss_gate=POD_BF16_LOSS_TOL)
                    else:
                        grad_rel = errs["leaf_max"]
                        passed = loss_rel <= gate and grad_rel <= gate
                        row.update(grad_gate="each leaf normwise")
                    row.update(against="2x2", loss_rel=loss_rel,
                               grad_rel=grad_rel, worst_leaf=errs["leaf"],
                               grad_leaf_max_rel=errs["leaf_max"],
                               gate=gate, passed=passed)
                    ok &= passed
                ok &= all(map(math.isfinite, losses))
                if on_card:
                    ok &= fa.LAUNCHES > 0 and sw.LAUNCHES > 0
                print(json.dumps(row), flush=True)
            del params, state, bundle, model
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
    flags = [None] * world
    dist.all_gather_object(flags, ok)
    if rank == 0:
        print(json.dumps({"phase": "done", "ok": bool(flags[0]),
                          "arch": POD_ARCH, "gpu": gpu}), flush=True)
    return 0 if flags[0] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' rehearses on gloo (default: the cards)")
    ap.add_argument("--test-mesh", action="store_true",
                    help="the reduced config (with --device cpu)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--arch", default=None, choices=ARCHS_RUN,
                    help=f"default {ARCH} (train), {DECODE_ARCH} (decode)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adamw_int8"),
                    help="AdamW's moments: fp32, or the reference's int8 "
                         "blocks")
    ap.add_argument("--decode", action="store_true",
                    help="a sharded decode over a long cache instead of a "
                         "train step")
    ap.add_argument("--shape", default=None, choices=("long_500k",),
                    help="the decode's shape (default: 32 sequences over "
                         "32,768 positions)")
    ap.add_argument("--allreduce", action="store_true",
                    help="the bus bandwidth of a 1 GiB all-reduce")
    ap.add_argument("--suite", action="store_true",
                    help="the all-reduce, zamba2-7b's long_500k decode and "
                         "the vision LM's int8 train step, in turn")
    ap.add_argument("--multi-pod", action="store_true",
                    help="llama3.2-3b's train step on the (pod, data, "
                         "model) meshes (2, 1, 2) and (2, 2, 1) against "
                         "(2, 2)")
    args = ap.parse_args(argv)

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
        if args.multi_pod:
            return run_multipod(args, rank, world, device, on_card, gpu)
        if args.suite:
            plan = SUITE
        elif args.allreduce:
            plan = (("allreduce", None, None),)
        elif args.decode:
            plan = (("decode", args.arch, args.shape),)
        else:
            plan = (("train", args.arch, args.optimizer),)
        rc = 0
        for mode, arch, extra in plan:
            if mode == "allreduce":
                rc |= run_allreduce(rank, world, device, on_card, gpu,
                                    args.test_mesh)
            elif mode == "decode":
                rc |= run_decode(argparse.Namespace(
                    **{**vars(args), "arch": arch, "shape": extra}), rank,
                    world, device, on_card, gpu)
            else:
                rc |= run_train(argparse.Namespace(
                    **{**vars(args), "arch": arch, "optimizer": extra}),
                    rank, world, device, on_card, gpu)
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
        return rc
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
