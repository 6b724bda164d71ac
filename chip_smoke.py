#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) through its main paths and checks
them:

1. device and build: the card's name and power limit, then the eight
   sm_90a sources built at once from the checkout (flash attention's
   ``csrc/flash_fwd_wgmma.cu`` and ``csrc/flash_fwd.cu``, the SSD chunk's
   ``csrc/ssd_chunk_wgmma.cu`` and ``csrc/ssd_chunk.cu``, the mLSTM
   chunk's ``csrc/mlstm_chunk_wgmma.cu`` and ``csrc/mlstm_chunk.cu``, and
   fused SwiGLU's ``csrc/fused_swiglu_wgmma.cu`` and
   ``csrc/fused_swiglu.cu``, one nvcc each; the four wgmma kernels include
   ``kernels/csrc/hopper.cuh``), with ptxas' reports;
2. kernels: each kernel against its plain PyTorch twin, in every variant
   its wrapper can choose (flash: wgmma for bf16, simt for fp32 and, forced,
   for bf16; SwiGLU: wgmma for bf16 rows TMA can describe, mma_sync for the
   others and, forced, for those too, simt for fp32; SSD and mLSTM: wgmma
   (3xTF32) for the shapes it takes and, forced, simt beside it, simt
   alone for the others), and the wrapper's choice checked.  Flash: the six
   ``FLASH_CASES`` x {f32, bf16}, D = 112 cases, and the full-width
   llama3.2-3b (D = 128) and zamba2-7b (D = 112) layer shapes, ragged and
   full.  SSD: the four ``SSD_CASES`` of tests/test_kernels.py, zamba2-7b's
   mamba layer at B = 2, S = 4096 and at a ragged S = 4000, all three
   outputs.  mLSTM: the four ``MLSTM_CASES`` of tests/test_kernels.py,
   xlstm-1.3b's mLSTM layer at B = 2, S = 4096 and at a ragged S = 4000,
   all seven outputs.  Fused SwiGLU: the four ``SWIGLU_CASES`` of
   tests/test_kernels.py, llama3.2-3b's and zamba2-7b's MLPs and
   granite-moe-1b-a400m's experts at their prefill steps' shapes, a ragged
   batch and a decode step's, in f32 and bf16.  Then the times of each
   kernel, its twin and a library yardstick where there is one
   (``scaled_dot_product_attention`` for flash, one cuBLAS product with
   [Wg | Wu] for SwiGLU; the port never calls either; no single PyTorch call
   computes the SSD or the mLSTM chunk), beside the bound (for SSD and
   mLSTM at the tf32 tensor-core peak); the earlier design (flash simt,
   SwiGLU mma_sync, SSD and mLSTM simt) forced and timed in turns with the
   new one; SwiGLU also at two decode shapes;
3. llama3.2-3b prefill step: full width (28 layers, random weights from a
   seeded generator), B = 2, S = 4096, bf16, ``attention_impl="pallas"``,
   with 28 flash and 28 SwiGLU launches counted, all wgmma; then the
   kernel path
   against the plain (naive) attention path with the same weights in fp32
   at full width;
4. llama3.2-3b generate: 4 requests of 512 prompt tokens + 16 greedy
   tokens through ``repro_torch.launch.serve.generate``, and the batched
   prefill == sequential decode fill invariant on a short prompt;
5. zamba2-7b prefill step: full width and depth (81 mamba layers, the
   shared attention block applied 13 times), B = 2, S = 4096, bf16,
   ``attention_impl="pallas"``, with 81 SSD, 13 flash and 13 SwiGLU
   launches counted, all wgmma;
6. zamba2-7b generate: 4 requests of 128 prompt tokens + 16 greedy tokens,
   the state filled token by token (the family has no batched prefill);
7. zamba2-7b fp32 parity: at full width and a depth of 7 (one group of 6
   and one tail layer), the kernel path on the card against the plain path
   (the same weights on the CPU, where every wrapper runs its twin);
8. xlstm-1.3b prefill step: full width and depth (6 groups of 7 mLSTM
   blocks and 1 sLSTM block), B = 2, S = 4096, bf16, with the 42 mLSTM
   kernel launches counted, all wgmma;
9. xlstm-1.3b generate: 4 requests of 128 prompt tokens + 16 greedy
   tokens, the state filled token by token (the family has no batched
   prefill, so the kernel is not launched);
10. xlstm-1.3b fp32 parity: at full width and a depth of 8 (7 mLSTM blocks
   and 1 sLSTM block), S = 640 (three chunks, the last ragged), the kernel
   path on the card against the plain path on the CPU;
11. granite-moe-1b-a400m prefill step: full width and depth (24 layers,
   32 experts top-8), B = 2, S = 4096, bf16, with 24 flash and 24 SwiGLU
   launches counted (every expert of a layer in one launch);
12. granite-moe-1b-a400m generate: 4 requests of 512 prompt tokens + 16
   greedy tokens through the batched prefill, with the SwiGLU launches
   counted (24 in the prefill and in each decode step);
13. granite-moe-1b-a400m fp32 parity: at full width and a depth of 4, S =
   640, the kernel path on the card against the plain path on the CPU,
   the routing (each layer's top-k mask) compared exactly;
14. bf16 parity: llama3.2-3b (depth 2), zamba2-7b (7), granite-moe-1b-a400m
   (4) and xlstm-1.3b (8) at full width, S = 640, the card path (every
   kernel launch wgmma) against the plain path on the CPU, normwise within
   2e-2; granite-moe's CPU path replays the card's expert choices and the
   choices it would have flipped are counted; xlstm-1.3b is held per
   mLSTM block (its depth-8 logits move by ~0.1 between two correct fp32
   mLSTM implementations) and its logits are reported;
15. paper_zoo, the paper's own path (``repro_torch.core``: LayerGraph ->
   compile_plan -> replay -> grads): all 16 ``ZOO`` graphs at the zoo's own
   widths (150528-wide inputs, 3x224x224 images), batch 64, planned with
   the swap-forcing ``MemoryPlanConfig(min_idle_phases=3, min_bytes=4096)``
   and replayed on ``sim`` and on ``async`` (the CUDA copy stream into one
   pinned host pool); each replay is held to the compiled op list, to no
   late swap-in, to its planned peak and DMA bytes, to the other backend's
   transfer accounting, and to ``reference_loss_and_grads`` (autograd) on
   the card, elementwise (rtol 1e-4, atol 1e-5 per unit of the tensor's
   largest entry) and normwise (1e-4); each row also gives how far the
   port's and autograd's fp32 grads lie from an fp64 autograd run;
16. paper_trunk: the llama3.2-3b MLP trunk (``transformer_mlp_stack()``: 28
   x (3072 -> 8192 relu -> 3072), MSE head) at batch 4096 rows in fp32,
   planned with the default config (swaps) and with ``swap=False``: three
   SGD steps on ``async`` over the swapped plan (its host pool pinned
   first, timed apart), one on ``sim`` and one on the no-swap plan (after
   a warm-up step); step-1 grads against autograd elementwise and
   normwise, and the allocator's measured peak during each replay
   (parameters and inputs subtracted), which must fall by at least half
   the planned saving against the no-swap replay.  Then five rounds of one
   swapped and one no-swap step in turns (ABBA), whose median step times
   are the phase's comparison of the two plans.

The bf16 prefill steps (3, 5, 8, 11) and generate's SwiGLU launches must
count under the wgmma variants only; in the fp32 parity phases (7, 10,
13) flash and SwiGLU count under simt and SSD and mLSTM under wgmma
(``LAUNCHES_BY_VARIANT``).  Every phase prints one
JSON line.  Any failed check exits non-zero.  TF32 is off for cuDNN and
for matmuls throughout.  Before the kernel table comes the paper path's
table (one row per graph, backend and plan).  The line before the last is
the kernel table (each row with its ``variant`` and ``prev_ms``, the
earlier design's time in this run), the last the device line.  It
needs the card: without one, or without the repo's sources beside it, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W
# (tfloat32: the tensor cores on tf32 operands, the rate of each pass
# of a 3xTF32 product)
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

FLASH_CASES = [
    # (b, hq, hkv, sq, skv, d, causal, block_q, block_kv), tests/test_kernels.py
    (1, 2, 2, 128, 128, 64, True, 64, 64),
    (2, 4, 2, 256, 256, 64, True, 128, 128),
    (1, 8, 1, 128, 128, 128, True, 64, 64),
    (1, 2, 2, 200, 200, 64, True, 64, 64),
    (1, 2, 2, 128, 256, 64, False, 64, 128),
    (2, 2, 2, 256, 256, 32, True, 256, 256),
]
FULL_SHAPE = (2, 24, 8, 4096, 4096, 128, True, 512, 1024)   # llama3.2-3b
RAGGED_SHAPE = (2, 24, 8, 1000, 1000, 128, True, 512, 1024)
D112_CASES = [(1, 2, 2, 200, 200, 112, True, 64, 64),
              (2, 32, 32, 1000, 1000, 112, True, 512, 1024)]
ZAMBA_SHAPE = (2, 32, 32, 4096, 4096, 112, True, 512, 1024)  # zamba2-7b
SSD_CASES = [
    # (b, s, h, p, n, chunk), tests/test_kernels.py:84-90
    (1, 64, 2, 16, 16, 32),
    (2, 128, 4, 32, 64, 64),
    (1, 100, 2, 16, 16, 32),
    (1, 32, 1, 64, 32, 32),
]
SSD_FULL = (2, 4096, 112, 64, 64, 256)      # zamba2-7b mamba layer, B = 2
SSD_RAGGED = (2, 4000, 112, 64, 64, 256)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)        # tests/test_kernels.py:105
MLSTM_CASES = [
    # (b, s, h, p, chunk), tests/test_kernels.py:130
    (1, 64, 2, 16, 32),
    (2, 128, 4, 32, 64),
    (1, 100, 2, 16, 32),
    (1, 32, 1, 64, 32),
]
MLSTM_FULL = (2, 4096, 4, 1024, 256)        # xlstm-1.3b mLSTM layer, B = 2
MLSTM_RAGGED = (2, 4000, 4, 1024, 256)
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py:151
GRANITE_SHAPE = (2, 16, 8, 4096, 4096, 64, True, 512, 1024)  # granite-moe
# the reference's full granite-moe-1b-a400m tree (tests/test_torch_moe.py):
# ModelConfig.param_count()'s 1,334,627,328 + the padded vocab rows + ln_f
GRANITE_PARAMS = 1_334_887_424
SWIGLU_CASES = [
    # (e, m, k, f), tests/test_kernels.py:175, a dense MLP each (e = 1)
    (1, 128, 256, 512),
    (1, 256, 512, 256),
    (1, 100, 200, 300),
    (1, 64, 64, 64),
]
# the prefill steps' shapes at B = 2, S = 4096 (M = B S; granite-moe: one
# launch for all 32 experts, M = G C = 2 x 1280), then a ragged batch with
# an unaligned K and a decode step's (4 requests)
SWIGLU_PATHS = {"llama3.2-3b MLP": (1, 8192, 3072, 8192),
                "zamba2-7b shared MLP": (1, 8192, 3584, 14336),
                "granite-moe-1b-a400m experts": (32, 2560, 1024, 512)}
SWIGLU_EXTRA = [(3, 1000, 1003, 700), (32, 4, 1024, 512)]
# decode steps' shapes (4 requests), timed beside the path shapes
SWIGLU_DECODE = {"llama3.2-3b MLP, decode": (1, 4, 3072, 8192),
                 "granite-moe-1b-a400m experts, decode": (32, 4, 1024, 512)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),       # tests/test_kernels.py
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the paper's path (phases 15-16): the executor tests' swap-forcing config
PAPER_EXEC = dict(min_idle_phases=3, min_bytes=1 << 12)
PAPER_ZOO_BATCH = 64
TRUNK_BATCH = 4096
TRUNK_STEPS = 3
# after the SGD steps: rounds of one swapped (async) and one no-swap step,
# in turns, for the medians of their step times
TRUNK_TIMED_ROUNDS = 5
# grads against autograd on the card: elementwise rtol 1e-4 with atol 1e-5
# per unit of the tensor's largest entry, and normwise max|a-b| <= 1e-4
# max|b|.  The port's backward (layer by layer, from the lowered schedule)
# and autograd's sum in different orders, and each fp32 result lies far
# further from the exact gradients than from the other (paper_zoo's rows
# carry both: grad_err against autograd, grad_err_fp64 and
# ref_grad_err_fp64 against an fp64 autograd run), so on resnet18 a plain
# atol of 1e-5 would hold mid-sized entries to more than fp32 computes.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_NORM_TOL = 1e-4
PAIRED_STATS = ("swap_outs", "prefetches", "inplace_prefetches", "dma_bytes",
                "hbm_high_water", "host_high_water", "peak_inflight_prefetch")
# fp32 full-width logits, kernel path vs plain path: max|a-b| / max|b|.
# Both sum in fp32 in another order through 28 layers; computing either in
# bf16 (or TF32) gives errors near 1e-2.
LOGITS_REL_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, phase: str, what: str) -> None:
    if not ok:
        emit({"phase": phase, "ok": False, "failed": what})
        sys.exit(1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_attention import kernel as fa
        from repro_torch.kernels.ssm_scan import kernel as ssd
        from repro_torch.kernels.mlstm_scan import kernel as ml
        from repro_torch.kernels.fused_swiglu import kernel as sw
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = gpu.splitlines()[0]
    print(gpu, flush=True)

    # ---- 1. build: one nvcc per source, started together -------------------
    t0 = time.perf_counter()
    sources = [fa.WGMMA_SOURCE, fa.SOURCE, ssd.WGMMA_SOURCE, ssd.SOURCE,
               ml.WGMMA_SOURCE, ml.SOURCE, sw.WGMMA_SOURCE, sw.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(_build.load, src) for src in sources]:
            fut.result()
    for m in (fa, ssd, ml, sw):
        for variant in m.VARIANTS:
            m.build(variant)
    emit({"phase": "build", "ok": True, "gpu": gpu,
          "build_s": time.perf_counter() - t0,
          "ptxas": {src.name: _build.ptxas_report(src) for src in sources}})

    llama_row, zamba_flash_row, granite_flash_row = \
        phase_kernels(torch, fa, gpu)
    ssd_row = phase_ssd_kernels(torch, ssd, gpu)
    mlstm_row = phase_mlstm_kernels(torch, ml, gpu)
    sw_rows = phase_swiglu_kernels(torch, sw, gpu)
    llama_row["launches"], sw_rows[0]["launches"] = \
        phase_prefill(torch, fa, sw, gpu)
    phase_generate(torch, fa, sw, gpu)
    ssd_row["launches"], zamba_flash_row["launches"], \
        sw_rows[1]["launches"] = phase_zamba(torch, fa, ssd, sw, gpu)
    phase_zamba_fp32_parity(torch, fa, ssd, sw)
    mlstm_row["launches"] = phase_xlstm(torch, ml, gpu)
    phase_xlstm_fp32_parity(torch, ml)
    granite_flash_row["launches"], sw_rows[2]["launches"] = \
        phase_granite(torch, fa, sw, gpu)
    phase_granite_fp32_parity(torch, fa, sw)
    phase_bf16_parity(torch, fa, ssd, ml, sw)
    _zero(fa, ssd, ml, sw)
    paper_rows = phase_paper_zoo(torch, gpu) + phase_paper_trunk(torch, gpu)
    check(all(m.LAUNCHES == 0 for m in (fa, ssd, ml, sw)), "paper_path",
          "the paper's path launched a kernel of the transformer path")

    emit({"phase": "done", "ok": True,
          "wall_s": time.perf_counter() - t_start})
    print(json.dumps({"paper_path": paper_rows}), flush=True)
    print(json.dumps({"kernels": [llama_row, zamba_flash_row, ssd_row,
                                  mlstm_row, *sw_rows,
                                  granite_flash_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _inputs(torch, case, dtype, seed):
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)


def _compare(got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, err.max().item()


def _zero(*mods):
    """Set the kernels' launch counts to 0, the counts by variant too."""
    for m in mods:
        if hasattr(m, "reset_launches"):
            m.reset_launches()
        else:
            m.LAUNCHES = 0


def _only(m, variant, n):
    """Whether kernel module ``m`` counted ``n`` launches, all of them
    under ``variant``."""
    return m.LAUNCHES == n and m.LAUNCHES_BY_VARIANT == {
        v: (n if v == variant else 0) for v in m.VARIANTS}


def _median_ms(torch, fn, reps, warmup=1, inner=5):
    """Median over ``reps`` of the time of one call, each taken from CUDA
    events around ``inner`` calls in a row, so the card never waits for
    the host's launch of the next one."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def _in_turns(torch, fns):
    """Each (fn, reps)'s median time, measured twice in turns (a, b, c, c,
    b, a) in this call; the lesser of the two medians for each."""
    times = [[] for _ in fns]
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        fn, reps = fns[i]
        times[i].append(_median_ms(torch, fn, reps=reps))
    return [min(t) for t in times]


def flash_bound(case, dtype_name):
    """Least time (ms) the card needs for one call: the larger of the
    operations this call's mask keeps over the dtype's peak and the bytes
    of q, k, v and o over HBM bandwidth."""
    b, hq, hkv, sq, skv, d, causal = case[:7]
    if causal:   # top-left: query row i sees keys 0..i
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    flops = 4 * d * b * hq * pairs
    nbytes = (2 if dtype_name == "bfloat16" else 4) * d * (
        2 * b * hq * sq + 2 * b * hkv * skv)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes"), flops


# ---------------------------------------------------------------------------
# 2. kernels against their plain twins
# ---------------------------------------------------------------------------

def flash_variants(dtype_name):
    """Every flash kernel the wrapper can choose for a dtype: fp32 runs the
    SIMT kernel; bf16 the wgmma kernel, and the SIMT (PR 14) design forced
    beside it."""
    return ["wgmma", "simt"] if dtype_name == "bfloat16" else ["simt"]


def phase_kernels(torch, fa, gpu):
    """The flash kernel against its twin in each variant, then its times at
    the llama3.2-3b (D = 128), zamba2-7b (D = 112) and granite-moe-1b-a400m
    (D = 64) layer shapes: one kernel-table row for each."""
    results = []
    cases = FLASH_CASES + D112_CASES + [RAGGED_SHAPE, FULL_SHAPE, ZAMBA_SHAPE,
                                        GRANITE_SHAPE]
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v = _inputs(torch, case, dtype, seed=len(results))
            causal, bq, bkv = case[6:]
            chosen = fa.variant_for(q, k, v)
            check(chosen == flash_variants(name)[0], "kernels",
                  f"{case} {name}: the wrapper chose {chosen}")
            want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                block_q=bq, block_kv=bkv)
            for variant in flash_variants(name):
                got = fa._launch(q, k, v, causal, variant)
                torch.cuda.synchronize()
                ok, err = _compare(got, want, **TOL[name])
                results.append({"case": list(case[:7]), "dtype": name,
                                "variant": variant, "max_abs_err": err,
                                "ok": ok})
                check(ok, "kernels",
                      f"{case} {name} {variant}: max_abs_err {err}")
                del got
            del q, k, v, want
    emit({"phase": "kernels", "ok": True, "kernel": "flash_attention_fwd",
          "checked": len(results),
          "worst": {vr: max(r["max_abs_err"] for r in results
                            if r["variant"] == vr) for vr in fa.VARIANTS},
          "results": results})
    return (_flash_times(torch, fa, gpu, FULL_SHAPE, "llama3.2-3b"),
            _flash_times(torch, fa, gpu, ZAMBA_SHAPE, "zamba2-7b"),
            _flash_times(torch, fa, gpu, GRANITE_SHAPE,
                         "granite-moe-1b-a400m"))


def _flash_times(torch, fa, gpu, shape, arch):
    """Times at a full-width layer shape, bf16 (what the prefill step
    runs): the kernel the wrapper chooses, the PR 14 design (SIMT, forced),
    the plain twin and SDPA, in turns, in this call."""
    import torch.nn.functional as F

    q, k, v = _inputs(torch, shape, torch.bfloat16, seed=123)
    causal, bq, bkv = shape[6:]
    variant = fa.variant_for(q, k, v)
    out = fa.flash_attention_fwd(q, k, v, causal=causal)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                        block_q=bq, block_kv=bkv)
    _, err = _compare(out, want, **TOL["bfloat16"])
    groups = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(groups, dim=1)
    vv = v.repeat_interleave(groups, dim=1)
    lib_out = F.scaled_dot_product_attention(q, kk, vv, is_causal=True)
    _, lib_err = _compare(out, lib_out, **TOL["bfloat16"])

    def new():
        return fa.flash_attention_fwd(q, k, v, causal=causal)

    def prev():
        return fa._launch(q, k, v, causal, "simt")

    def library():
        return F.scaled_dot_product_attention(q, kk, vv, is_causal=True)

    ms, prev_ms, library_ms = _in_turns(
        torch, [(new, 10), (prev, 3), (library, 10)])
    plain_ms = _median_ms(torch, lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal=causal, block_q=bq, block_kv=bkv), reps=5)
    bound_ms, bound_by, flops = flash_bound(shape, "bfloat16")
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "flash_attention_fwd", "arch": arch,
          "shape": list(shape[:7]), "dtype": "bfloat16", "variant": variant,
          "kernel_ms": ms, "prev_ms": prev_ms, "plain_ms": plain_ms,
          "sdpa_ms": library_ms, "sdpa_max_abs_diff": lib_err,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "sdpa_tflops": flops / library_ms / 1e9,
          "roofline_share": bound_ms / ms, "speedup_vs_prev": prev_ms / ms})
    del q, k, v, kk, vv, out, want, lib_out
    torch.cuda.empty_cache()
    return {"name": "flash_attention_fwd", "route": "cuda",
            "variant": variant,
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      + fa.SOURCES[variant].name,
            "replaces": "src/repro/kernels/flash_attention/kernel.py:91",
            "path": f"{arch} prefill step", "shape": list(shape[:7]),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "prev_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def ssd_bound(case):
    """Least time (ms) the card needs for one SSD chunk call on ``case``'s
    chunks: the larger of the matrix operations the function needs on the
    pairs the causal mask keeps over the tf32 tensor-core peak, and the
    fp32 bytes of its inputs and outputs over HBM bandwidth.  The tf32
    peak, not the fp32 CUDA-core one, because the tensor cores compute the
    same fp32-accurate products (3xTF32: three tf32 passes on split
    operands, each pass counted at the full rate): it is the least time
    for this work on this card.  B and C are one group, so C Bᵀ (2n per
    kept pair) is counted once per (batch, chunk); the decay-weighted
    product with X (2p per kept pair) and the state (2 Q n p) once per
    (batch, chunk, head)."""
    b, s, h, p, n, chunk = case
    q = min(chunk, s)
    nc = -(-s // q)
    ctas = b * nc * h
    pairs = q * (q + 1) // 2
    flops = b * nc * pairs * 2 * n + ctas * (pairs * 2 * p + 2 * q * n * p)
    floats = (2 * b * nc * q * h * p          # x, y
              + b * nc * q * h + h            # dt, A_log
              + 2 * b * nc * q * n            # B, C
              + ctas * n * p + ctas)          # states, chunk_lf
    t_ops = flops / PEAK_FLOPS["tfloat32"]
    t_bytes = 4 * floats / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes"), flops, 4 * floats


def _ssd_inputs(torch, case, seed):
    """Chunked (padded) float32 inputs with tests/test_kernels.py's
    distributions: x, B, C normal, dt = softplus(normal), A_log 0.5 normal."""
    from repro_torch.kernels.ssm_scan.ops import chunk_inputs

    b, s, h, p, n, chunk = case
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x, B, C = rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n)
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A_log = rnd(h) * 0.5
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, chunk)
    return xc, dtc, A_log, Bc, Cc


def ssd_variant(case):
    """The SSD kernel the wrapper should choose: wgmma for n = p = 64 and
    chunks of whole 64-row tiles up to 256, else simt."""
    _, s, _, p, n, chunk = case
    q = min(chunk, s)
    return "wgmma" if p == n == 64 and q % 64 == 0 and q <= 256 else "simt"


def mlstm_variant(case):
    """The mLSTM kernel the wrapper should choose: wgmma for head dims
    that are multiples of 128 and chunks of whole 64-row tiles up to 256,
    else simt."""
    _, s, _, p, chunk = case
    q = min(chunk, s)
    return "wgmma" if p % 128 == 0 and q % 64 == 0 and q <= 256 else "simt"


def _twin_checks(torch, m, kernel, cases, make_inputs, names, tol,
                 expected):
    """Each case's every variant (the one the wrapper should choose, and
    the earlier simt design forced beside a wgmma one) against the
    plain twin, all outputs finite and within ``tol``; the wrapper's
    choice checked.  Returns the results."""
    plain = getattr(m, f"{kernel}_plain")
    results = []
    for case in cases:
        ins = make_inputs(torch, case, seed=len(results))
        chosen = m.variant_for(*ins[:5])
        check(chosen == expected(case), kernel,
              f"{case}: the wrapper chose {chosen}")
        want = plain(*ins)
        for variant in dict.fromkeys([chosen, "simt"]):
            got = m._launch(*ins, variant)
            torch.cuda.synchronize()
            errs = []
            for name, g, w in zip(names, got, want):
                ok, err = _compare(g, w, **tol)
                check(ok and bool(g.isfinite().all()), kernel,
                      f"{case} {variant} {name}: max_abs_err {err}")
                errs.append(err)
            results.append({"case": list(case), "variant": variant,
                            "max_abs_err": max(errs),
                            "per_output": dict(zip(names, errs)),
                            "ok": True})
            del got
        del ins, want
    emit({"phase": "kernels", "ok": True, "kernel": kernel,
          "checked": len(results), "tol": tol,
          "worst": {vr: max(r["max_abs_err"] for r in results
                            if r["variant"] == vr)
                    for vr in m.VARIANTS
                    if any(r["variant"] == vr for r in results)},
          "results": results})
    return results


def _scan_times(torch, m, kernel, ins, reps):
    """The kernel the wrapper chooses and the earlier simt design,
    in turns, in this call; then the plain twin."""
    fn, plain = getattr(m, kernel), getattr(m, f"{kernel}_plain")
    ms, prev_ms = _in_turns(torch, [
        (lambda: fn(*ins), reps), (lambda: m._launch(*ins, "simt"), reps)])
    plain_ms = _median_ms(torch, lambda: plain(*ins), reps=3)
    return ms, prev_ms, plain_ms


SSD_OUTPUTS = ("y_diag", "states", "chunk_lf")


def phase_ssd_kernels(torch, ssd, gpu):
    """The SSD kernel against its twin (all three outputs) in every
    variant, then its times at zamba2-7b's full-width shape: the wgmma
    kernel and the earlier simt design in turns; the kernel-table row."""
    _twin_checks(torch, ssd, "ssd_chunk", SSD_CASES + [SSD_RAGGED, SSD_FULL],
                 _ssd_inputs, SSD_OUTPUTS, SSD_TOL, ssd_variant)
    ins = _ssd_inputs(torch, SSD_FULL, seed=321)
    variant = ssd.variant_for(*ins)
    err = max(_compare(g, w, **SSD_TOL)[1] for g, w in
              zip(ssd.ssd_chunk(*ins), ssd.ssd_chunk_plain(*ins)))
    ms, prev_ms, plain_ms = _scan_times(torch, ssd, "ssd_chunk", ins, 20)
    bound_ms, bound_by, flops, nbytes = ssd_bound(SSD_FULL)
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "ssd_chunk", "arch": "zamba2-7b",
          "shape": dict(zip("b s h p n chunk".split(), SSD_FULL)),
          "variant": variant, "kernel_ms": ms, "prev_ms": prev_ms,
          "plain_ms": plain_ms, "library_ms": None,
          "library_note": "no single PyTorch call computes the SSD chunk "
                          "(a masked decay-weighted product and the chunk "
                          "state)",
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "roofline_share": bound_ms / ms,
          "prev_roofline_share": bound_ms / prev_ms,
          "speedup_vs_prev": prev_ms / ms})
    del ins
    torch.cuda.empty_cache()
    return {"name": "ssd_chunk", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/ssm_scan/csrc/"
                      + ssd.SOURCES[variant].name,
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:61",
            "path": "zamba2-7b prefill step", "shape": list(SSD_FULL),
            "launches": 0, "max_abs_err": err, "ms": ms, "prev_ms": prev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def mlstm_bound(case):
    """Least time (ms) the card needs for one mLSTM chunk call on ``case``'s
    chunks: the larger of the operations the function needs over the tf32
    tensor-core peak (per (batch, chunk, head): 2p flops on each pair the
    causal mask keeps for q kᵀ and again for W v, 2 Q p² for the state and
    2 Q p for the norm) and the fp32 bytes of its inputs and outputs over
    HBM bandwidth.  The tf32 peak, not the fp32 CUDA-core one, because the
    tensor cores compute the same fp32-accurate products (3xTF32, each
    pass counted at the full rate): it is the least time for this work on
    this card."""
    b, s, h, p, chunk = case
    q = min(chunk, s)
    nc = -(-s // q)
    units = b * nc * h
    pairs = q * (q + 1) // 2
    flops = units * (2 * pairs * 2 * p + 2 * q * p * p + 2 * q * p)
    rows = b * nc * q * h
    floats = (4 * rows * p                    # q, k, v, y_intra
              + 4 * rows                      # li, lf, n_intra, m_intra
              + units * (p * p + p + 2))      # states, norms, 2 scalars
    t_ops = flops / PEAK_FLOPS["tfloat32"]
    t_bytes = 4 * floats / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes"), flops, 4 * floats


def _mlstm_inputs(torch, case, seed):
    """Chunked (padded) float32 inputs with tests/test_kernels.py's
    distributions: q, k, v ~ N(0, 1), ig ~ 2 N, fg ~ 2 N + 2."""
    from repro_torch.kernels.mlstm_scan.ops import chunk_inputs

    b, s, h, p, chunk = case
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q, k, v = rnd(b, s, h, p), rnd(b, s, h, p), rnd(b, s, h, p)
    ig, fg = rnd(b, s, h) * 2, rnd(b, s, h) * 2 + 2
    return (*chunk_inputs(q, k, v, ig, fg, chunk), 1 / math.sqrt(p))


MLSTM_OUTPUTS = ("y_intra", "n_intra", "m_intra", "states", "norms",
                 "chunk_lf", "m_state")


def phase_mlstm_kernels(torch, ml, gpu):
    """The mLSTM kernel against its twin (all seven outputs) in every
    variant, then its times at xlstm-1.3b's full-width shape: the wgmma
    kernel and the earlier simt design in turns; the kernel-table row."""
    _twin_checks(torch, ml, "mlstm_chunk",
                 MLSTM_CASES + [MLSTM_RAGGED, MLSTM_FULL], _mlstm_inputs,
                 MLSTM_OUTPUTS, MLSTM_TOL, mlstm_variant)
    ins = _mlstm_inputs(torch, MLSTM_FULL, seed=321)
    variant = ml.variant_for(*ins[:5])
    err = max(_compare(g, w, **MLSTM_TOL)[1] for g, w in
              zip(ml.mlstm_chunk(*ins), ml.mlstm_chunk_plain(*ins)))
    ms, prev_ms, plain_ms = _scan_times(torch, ml, "mlstm_chunk", ins, 10)
    bound_ms, bound_by, flops, nbytes = mlstm_bound(MLSTM_FULL)
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "mlstm_chunk", "arch": "xlstm-1.3b",
          "shape": dict(zip("b s h p chunk".split(), MLSTM_FULL)),
          "variant": variant, "kernel_ms": ms, "prev_ms": prev_ms,
          "plain_ms": plain_ms, "library_ms": None,
          "library_note": "no single PyTorch call computes the mLSTM chunk "
                          "(a masked, stabilised decay-weighted product, "
                          "the chunk state and its norm)",
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "roofline_share": bound_ms / ms,
          "prev_roofline_share": bound_ms / prev_ms,
          "speedup_vs_prev": prev_ms / ms})
    del ins
    torch.cuda.empty_cache()
    return {"name": "mlstm_chunk", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/mlstm_scan/csrc/"
                      + ml.SOURCES[variant].name,
            "replaces": "src/repro/kernels/mlstm_scan/kernel.py:65",
            "path": "xlstm-1.3b prefill step", "shape": list(MLSTM_FULL),
            "launches": 0, "max_abs_err": err, "ms": ms, "prev_ms": prev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def swiglu_bound(case, dtype_name):
    """Least time (ms) the card needs for one fused SwiGLU call: the larger
    of the two products' 4 E M K F flops over the dtype's peak and the
    bytes of x, Wg, Wu and h over HBM bandwidth."""
    e, m, k, f = case
    flops = 4 * e * m * k * f
    nbytes = (2 if dtype_name == "bfloat16" else 4) * e * (
        m * k + 2 * k * f + m * f)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def _swiglu_inputs(torch, case, dtype, seed):
    """x ~ 0.5 N, wg, wu ~ 0.05 N (tests/test_kernels.py); the dense
    (M, K) form for e = 1, the expert form (E, M, K) otherwise."""
    e, m, k, f = case
    g = torch.Generator("cuda").manual_seed(seed)

    def rnd(shape, scale):
        t = torch.randn(shape, generator=g, device="cuda") * scale
        return t.to(dtype)

    x, wg, wu = rnd((e, m, k), 0.5), rnd((e, k, f), 0.05), \
        rnd((e, k, f), 0.05)
    return (x[0], wg[0], wu[0]) if e == 1 else (x, wg, wu)


def swiglu_variants(case, dtype_name):
    """Every SwiGLU kernel the wrapper can choose for a case and dtype: fp32
    runs the SIMT kernel; bf16 the wgmma kernel where TMA can describe the
    rows (K, F multiples of 8), with the mma.sync (PR 14) design forced
    beside it, else the mma.sync kernel alone."""
    if dtype_name == "float32":
        return ["simt"]
    _, _, k, f = case
    return ["wgmma", "mma_sync"] if k % 8 == 0 and f % 8 == 0 \
        else ["mma_sync"]


def phase_swiglu_kernels(torch, sw, gpu):
    """The fused SwiGLU kernel against its twin in f32 and bf16, in each
    variant, then its times at each path's shape in bf16 (what the prefill
    steps run): one kernel-table row for each; then the decode shapes."""
    results = []
    for case in SWIGLU_CASES + list(SWIGLU_PATHS.values()) + SWIGLU_EXTRA:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            ins = _swiglu_inputs(torch, case, dtype, seed=len(results))
            variants = swiglu_variants(case, name)
            chosen = sw.variant_for(*ins)
            check(chosen == variants[0], "swiglu_kernels",
                  f"{case} {name}: the wrapper chose {chosen}")
            want = sw.fused_swiglu_plain(*ins)
            for variant in variants:
                got = sw._launch(*ins, variant)
                torch.cuda.synchronize()
                ok, err = _compare(got, want, **TOL[name])
                check(ok and bool(got.isfinite().all()), "swiglu_kernels",
                      f"{case} {name} {variant}: max_abs_err {err}")
                results.append({"case": list(case), "dtype": name,
                                "variant": variant, "max_abs_err": err,
                                "ok": ok})
                del got
            del ins, want
    emit({"phase": "kernels", "ok": True, "kernel": "fused_swiglu",
          "checked": len(results),
          "worst": {vr: max(r["max_abs_err"] for r in results
                            if r["variant"] == vr) for vr in sw.VARIANTS},
          "results": results})
    rows = [_swiglu_times(torch, sw, gpu, case, path)
            for path, case in SWIGLU_PATHS.items()]
    for path, case in SWIGLU_DECODE.items():
        _swiglu_times(torch, sw, gpu, case, path)
    torch.cuda.empty_cache()
    return rows


def _swiglu_times(torch, sw, gpu, case, path):
    """Times at one shape, bf16: the kernel the wrapper chooses, the PR 14
    design (mma.sync, forced), the plain twin and the cuBLAS yardstick, in
    turns, in this call."""
    x, wg, wu = _swiglu_inputs(torch, case, torch.bfloat16, seed=321)
    variant = sw.variant_for(x, wg, wu)
    out = sw.fused_swiglu(x, wg, wu)
    want = sw.fused_swiglu_plain(x, wg, wu)
    _, err = _compare(out, want, **TOL["bfloat16"])
    # yardstick: the two products as one cuBLAS call on [Wg | Wu]; no
    # single PyTorch call computes the fused function
    w_cat = torch.cat([wg, wu], dim=-1)
    ms, prev_ms, library_ms = _in_turns(torch, [
        (lambda: sw.fused_swiglu(x, wg, wu), 20),
        (lambda: sw._launch(x, wg, wu, "mma_sync"), 20),
        (lambda: torch.matmul(x, w_cat), 20)])
    plain_ms = _median_ms(torch, lambda: sw.fused_swiglu_plain(x, wg, wu),
                          reps=5)
    bound_ms, bound_by, flops, nbytes = swiglu_bound(case, "bfloat16")
    emit({"phase": "kernel_times", "ok": True, "gpu": gpu,
          "kernel": "fused_swiglu", "path": path,
          "shape": dict(zip("e m k f".split(), case)), "dtype": "bfloat16",
          "variant": variant, "kernel_ms": ms, "prev_ms": prev_ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library_note": "torch.matmul(x, [Wg | Wu]): the two products "
                          "only, no epilogue",
          "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes, "kernel_tflops": flops / ms / 1e9,
          "prev_tflops": flops / prev_ms / 1e9,
          "library_tflops": flops / library_ms / 1e9,
          "roofline_share": bound_ms / ms, "speedup_vs_prev": prev_ms / ms})
    del x, wg, wu, out, want, w_cat
    return {"name": "fused_swiglu", "route": "cuda", "variant": variant,
            "source": "src/repro_torch/kernels/fused_swiglu/csrc/"
                      + sw.SOURCES[variant].name,
            "replaces": "src/repro/kernels/fused_swiglu/kernel.py:56",
            "path": f"{path}, prefill step", "shape": list(case),
            "launches": 0, "max_abs_err": err, "ms": ms,
            "prev_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# 3. full-width prefill step
# ---------------------------------------------------------------------------

def phase_prefill(torch, fa, sw, gpu):
    """Returns the (flash, SwiGLU) launches of one counted prefill step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    from repro_torch.train.step import make_prefill_step

    base = ARCHS["llama3.2-3b"]
    cfg = dataclasses.replace(base, attention_impl="pallas")
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=g, device="cuda")
    batch = {"tokens": tokens}

    model = build_model(cfg)
    params = model.init(0)
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(fa, sw)                               # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, sw_launches = fa.LAUNCHES, sw.LAUNCHES
    by_variant = {"flash": dict(fa.LAUNCHES_BY_VARIANT),
                  "swiglu": dict(sw.LAUNCHES_BY_VARIANT)}
    check(_only(fa, "wgmma", cfg.n_layers), "prefill",
          f"flash launches {by_variant['flash']}, expected {cfg.n_layers} "
          "wgmma")
    check(_only(sw, "wgmma", cfg.n_layers), "prefill",
          f"SwiGLU launches {by_variant['swiglu']}, expected "
          f"{cfg.n_layers} wgmma")
    check(logits.shape == (b, s, 128256) and bool(logits.isfinite().all()),
          "prefill", f"logits {tuple(logits.shape)} not finite")
    times = [first_s]
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    arg_kernel = logits[..., :cfg.vocab].argmax(-1)
    del logits

    naive = build_model(dataclasses.replace(cfg, attention_impl="naive"))
    logits_plain = naive.forward(params, batch)
    agree = (logits_plain[..., :cfg.vocab].argmax(-1) == arg_kernel) \
        .float().mean().item()
    del logits_plain, params, arg_kernel
    torch.cuda.empty_cache()
    emit({"phase": "prefill", "ok": True, "gpu": gpu, "arch": cfg.name,
          "batch": b, "seq": s, "dtype": cfg.dtype,
          "kernel_launches": launches, "swiglu_launches": sw_launches,
          "launches_by_variant": by_variant, "step_s": step_s,
          "step_times_s": times, "tokens_per_s": b * s / step_s,
          "peak_gb": peak_gb, "bf16_argmax_agreement_vs_plain": agree})

    # fp32 at full width: kernel path against the plain path, same weights
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(0)
    pos = [0, 511, s - 1]
    with torch.no_grad():
        a = model32.forward(params32, batch)[:, pos].float()
        ref = build_model(dataclasses.replace(cfg32, attention_impl="naive")) \
            .forward(params32, batch)[:, pos].float()
    rel = ((a - ref).abs().max() / ref.abs().max()).item()
    del params32, a, ref
    torch.cuda.empty_cache()
    ok = rel <= LOGITS_REL_TOL
    emit({"phase": "prefill_fp32_parity", "ok": ok, "positions": pos,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL})
    check(ok, "prefill_fp32_parity", f"max_rel_err {rel}")
    return launches, sw_launches


# ---------------------------------------------------------------------------
# 4. generate through the server code
# ---------------------------------------------------------------------------

def phase_generate(torch, fa, sw, gpu):
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS["llama3.2-3b"], attention_impl="pallas")
    model = build_model(cfg)
    params = model.init(0)
    n_req, plen, gen_tokens = 4, 512, 16
    g = torch.Generator("cuda").manual_seed(11)
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts, 2)                   # warm-up
    _zero(fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    launches = fa.LAUNCHES
    toks = out.tokens
    check(_only(sw, "wgmma", cfg.n_layers * (gen_tokens + 1)), "generate",
          f"SwiGLU launches {sw.LAUNCHES_BY_VARIANT} in the prefill and "
          f"{gen_tokens} decode steps")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "generate", "ok": True, "gpu": gpu, "requests": n_req,
          "prompt": plen, "gen_tokens": gen_tokens, "mode": out.mode,
          "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "kernel_launches": launches, "swiglu_launches": sw.LAUNCHES,
          "swiglu_launches_by_variant": sw.LAUNCHES_BY_VARIANT,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()

    # batched prefill == sequential decode fill (tests/test_serve.py:551),
    # full width in fp32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(0)
    b, short, max_seq = 2, 8, 16
    ids = prompts[:b, :short]
    with torch.no_grad():
        seq = model32.decode_init(b, max_seq)
        for t in range(short):
            l_seq, seq = model32.decode_fn(
                params32, seq, ids[:, t],
                torch.full((b,), t, dtype=torch.int32, device="cuda"))
        pre = model32.decode_init(b, max_seq)
        l_pre, pre = model32.prefill_fn(params32, pre, ids)
    rel = ((l_pre - l_seq).abs().max() / l_seq.abs().max()).item()
    cache_err = max((pre[n] - seq[n]).abs().max().item() for n in ("k", "v"))
    ok = rel <= LOGITS_REL_TOL and cache_err <= LOGITS_REL_TOL
    emit({"phase": "prefill_equals_sequential_fill", "ok": ok,
          "prompt": short, "dtype": "float32", "max_rel_err": rel,
          "cache_max_abs_err": cache_err, "tol": LOGITS_REL_TOL})
    check(ok, "prefill_equals_sequential_fill",
          f"max_rel_err {rel}, cache {cache_err}")



# ---------------------------------------------------------------------------
# 5-6. zamba2-7b: full-width prefill step and generate
# ---------------------------------------------------------------------------

def phase_zamba(torch, fa, ssd, sw, gpu):
    """Returns the (SSD, flash, SwiGLU) launches of one counted prefill
    step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    from repro_torch.models.zamba import layout
    from repro_torch.train.step import make_prefill_step

    cfg = dataclasses.replace(ARCHS["zamba2-7b"], attention_impl="pallas")
    n_groups, _ = layout(cfg)
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device="cuda")}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(ssd, fa, sw)                          # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    ssd_launches, flash_launches = ssd.LAUNCHES, fa.LAUNCHES
    sw_launches = sw.LAUNCHES
    by_variant = {"flash": dict(fa.LAUNCHES_BY_VARIANT),
                  "swiglu": dict(sw.LAUNCHES_BY_VARIANT)}
    check(_only(sw, "wgmma", n_groups), "zamba_prefill",
          f"SwiGLU launches {by_variant['swiglu']} for {n_groups} "
          "applications, expected all wgmma")
    by_variant["ssd"] = dict(ssd.LAUNCHES_BY_VARIANT)
    check(_only(ssd, "wgmma", cfg.n_layers), "zamba_prefill",
          f"SSD launches {by_variant['ssd']} for {cfg.n_layers} mamba "
          "layers, expected all wgmma")
    check(_only(fa, "wgmma", n_groups), "zamba_prefill",
          f"flash launches {by_variant['flash']} for {n_groups} "
          "applications, expected all wgmma")
    check(logits.shape == (b, s, 32000) and bool(logits.isfinite().all()),
          "zamba_prefill", f"logits {tuple(logits.shape)} not finite")
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del logits
    emit({"phase": "zamba_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "layers": cfg.n_layers, "groups": n_groups,
          "batch": b, "seq": s, "dtype": cfg.dtype,
          "logits_shape": [b, s, 32000], "ssd_launches": ssd_launches,
          "flash_launches": flash_launches, "swiglu_launches": sw_launches,
          "launches_by_variant": by_variant, "init_s": init_s,
          "weights_gb": weights_gb, "step_s": step_s, "step_times_s": times,
          "tokens_per_s": b * s / step_s, "peak_gb": peak_gb})

    n_req, plen, gen_tokens = 4, 128, 16
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts[:, :4], 2)           # warm-up
    _zero(ssd, fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    check(out.mode == "sequential", "zamba_generate", f"mode {out.mode}")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "zamba_generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "zamba_generate", "ok": True, "gpu": gpu,
          "requests": n_req, "prompt": plen, "gen_tokens": gen_tokens,
          "mode": out.mode, "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "ssd_launches": ssd.LAUNCHES, "flash_launches": fa.LAUNCHES,
          "swiglu_launches": sw.LAUNCHES,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return ssd_launches, flash_launches, sw_launches


# ---------------------------------------------------------------------------
# 7. zamba2-7b fp32: kernel path on the card against the plain path
# ---------------------------------------------------------------------------

def phase_zamba_fp32_parity(torch, fa, ssd, sw):
    """Full width, depth 7 (one group of 6 mamba layers + the shared block,
    then one tail layer), S = 640 > block_q so the flash kernel runs and
    the last of three SSD chunks is ragged.  The plain path is the same
    weights on the CPU, where every kernel wrapper runs its plain twin."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    from repro_torch.models.zamba import layout

    cfg = dataclasses.replace(ARCHS["zamba2-7b"], attention_impl="pallas",
                              dtype="float32", n_layers=7)
    expected = {"ssd": cfg.n_layers, "flash": layout(cfg)[0],
                "swiglu": layout(cfg)[0]}
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                           device="cuda")
    _zero(ssd, fa, sw)
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens}).cpu()
    launches = {"ssd": ssd.LAUNCHES, "flash": fa.LAUNCHES,
                "swiglu": sw.LAUNCHES}
    check(launches == expected and _only(fa, "simt", expected["flash"])
          and _only(sw, "simt", expected["swiglu"])
          and _only(ssd, "wgmma", expected["ssd"]), "zamba_fp32_parity",
          f"kernel launches {launches}, expected {expected}: SSD all wgmma "
          f"{ssd.LAUNCHES_BY_VARIANT}, flash and SwiGLU all fp32 (simt) "
          f"{fa.LAUNCHES_BY_VARIANT} {sw.LAUNCHES_BY_VARIANT}")
    params_cpu = copy.deepcopy(params).to("cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model.forward(params_cpu, {"tokens": tokens.cpu()})
    cpu_s = time.perf_counter() - t0
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = rel <= LOGITS_REL_TOL and bool(got.isfinite().all())
    emit({"phase": "zamba_fp32_parity", "ok": ok, "layers": cfg.n_layers,
          "batch": 1, "seq": 640, "kernel_launches": launches,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL,
          "plain_path_cpu_s": cpu_s})
    check(ok, "zamba_fp32_parity", f"max_rel_err {rel}")


# ---------------------------------------------------------------------------
# 8-9. xlstm-1.3b: full-width prefill step and generate
# ---------------------------------------------------------------------------

def phase_xlstm(torch, ml, gpu):
    """Returns the mLSTM kernel launches of one counted prefill step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab, xlstm_layout
    from repro_torch.train.step import make_prefill_step

    cfg = ARCHS["xlstm-1.3b"]
    n_groups, per = xlstm_layout(cfg)
    vocab = padded_vocab(cfg)
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(19)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device="cuda")}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(ml)                                   # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = ml.LAUNCHES
    by_variant = dict(ml.LAUNCHES_BY_VARIANT)
    check(_only(ml, "wgmma", n_groups * per), "xlstm_prefill",
          f"mLSTM launches {ml.LAUNCHES_BY_VARIANT} for {n_groups * per} "
          "mLSTM blocks, expected all wgmma")
    check(logits.shape == (b, s, vocab) and bool(logits.isfinite().all()),
          "xlstm_prefill", f"logits {tuple(logits.shape)} not finite")
    del logits
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "xlstm_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "layers": cfg.n_layers,
          "mlstm_blocks": n_groups * per, "slstm_blocks": n_groups,
          "batch": b, "seq": s, "dtype": cfg.dtype,
          "logits_shape": [b, s, vocab], "mlstm_launches": launches,
          "mlstm_launches_by_variant": by_variant,
          "init_s": init_s, "weights_gb": weights_gb, "step_s": step_s,
          "step_times_s": times, "tokens_per_s": b * s / step_s,
          "peak_gb": peak_gb})

    n_req, plen, gen_tokens = 4, 128, 16
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts[:, :4], 2)           # warm-up
    _zero(ml)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    check(out.mode == "sequential", "xlstm_generate", f"mode {out.mode}")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "xlstm_generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "xlstm_generate", "ok": True, "gpu": gpu,
          "requests": n_req, "prompt": plen, "gen_tokens": gen_tokens,
          "mode": out.mode, "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "mlstm_launches": ml.LAUNCHES,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 10. xlstm-1.3b fp32: kernel path on the card against the plain path
# ---------------------------------------------------------------------------

def phase_xlstm_fp32_parity(torch, ml):
    """Full width, depth 8 (one group: 7 mLSTM blocks and the sLSTM block),
    S = 640: three mLSTM chunks of 256, the last ragged.  The plain path is
    the same weights on the CPU, where the kernel wrapper runs its twin."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import xlstm_layout

    cfg = dataclasses.replace(ARCHS["xlstm-1.3b"], dtype="float32",
                              n_layers=8)
    n_groups, per = xlstm_layout(cfg)
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(23)
    tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                           device="cuda")
    _zero(ml)
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens}).cpu()
    launches = ml.LAUNCHES
    check(n_groups * per == 7 and _only(ml, "wgmma", 7), "xlstm_fp32_parity",
          f"mLSTM launches {ml.LAUNCHES_BY_VARIANT}, expected 7 wgmma")
    params_cpu = copy.deepcopy(params).to("cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        want = model.forward(params_cpu, {"tokens": tokens.cpu()})
    cpu_s = time.perf_counter() - t0
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = rel <= LOGITS_REL_TOL and bool(got.isfinite().all())
    emit({"phase": "xlstm_fp32_parity", "ok": ok, "layers": cfg.n_layers,
          "batch": 1, "seq": 640, "mlstm_launches": launches,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL,
          "plain_path_cpu_s": cpu_s})
    check(ok, "xlstm_fp32_parity", f"max_rel_err {rel}")


# ---------------------------------------------------------------------------
# 11-12. granite-moe-1b-a400m: full-width prefill step and generate
# ---------------------------------------------------------------------------

def phase_granite(torch, fa, sw, gpu):
    """Returns the (flash, SwiGLU) launches of one counted prefill step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import padded_vocab
    from repro_torch.train.step import make_prefill_step

    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"],
                              attention_impl="pallas")
    vocab = padded_vocab(cfg)
    b, s = 2, 4096
    g = torch.Generator("cuda").manual_seed(29)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     device="cuda")}
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == GRANITE_PARAMS, "granite_prefill",
          f"{n_params} parameters, not {GRANITE_PARAMS}")
    weights_gb = sum(p.numel() * p.element_size()
                     for p in params.parameters()) / 1e9
    step = make_prefill_step(model)
    step(params, batch)                         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(fa, sw)                               # counted main-path run
    t0 = time.perf_counter()
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    flash_launches, sw_launches = fa.LAUNCHES, sw.LAUNCHES
    by_variant = {"flash": dict(fa.LAUNCHES_BY_VARIANT),
                  "swiglu": dict(sw.LAUNCHES_BY_VARIANT)}
    check(_only(fa, "wgmma", cfg.n_layers), "granite_prefill",
          f"flash launches {by_variant['flash']} for {cfg.n_layers} "
          "layers, expected all wgmma")
    check(_only(sw, "wgmma", cfg.n_layers), "granite_prefill",
          f"SwiGLU launches {by_variant['swiglu']} for {cfg.n_layers} MoE "
          "layers, expected all wgmma")
    check(logits.shape == (b, s, vocab) and bool(logits.isfinite().all()),
          "granite_prefill", f"logits {tuple(logits.shape)} not finite")
    del logits
    for _ in range(2):
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "granite_prefill", "ok": True, "gpu": gpu,
          "arch": cfg.name, "layers": cfg.n_layers,
          "experts": cfg.n_experts, "top_k": cfg.top_k, "batch": b,
          "seq": s, "dtype": cfg.dtype, "logits_shape": [b, s, vocab],
          "flash_launches": flash_launches, "swiglu_launches": sw_launches,
          "launches_by_variant": by_variant, "params": n_params, "init_s": init_s, "weights_gb": weights_gb,
          "step_s": step_s, "step_times_s": times,
          "tokens_per_s": b * s / step_s, "peak_gb": peak_gb})

    n_req, plen, gen_tokens = 4, 512, 16
    prompts = torch.randint(0, cfg.vocab, (n_req, plen), generator=g,
                            device="cuda")
    generate(model, params, prompts, 2)                   # warm-up
    _zero(fa, sw)
    out = generate(model, params, prompts, gen_tokens)
    toks = out.tokens
    check(out.mode == "batched", "granite_generate", f"mode {out.mode}")
    check(_only(sw, "wgmma", cfg.n_layers * (gen_tokens + 1)),
          "granite_generate",
          f"SwiGLU launches {sw.LAUNCHES_BY_VARIANT} in the prefill and "
          f"{gen_tokens} decode steps")
    check(toks.shape == (n_req, gen_tokens)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "granite_generate", f"tokens {tuple(toks.shape)} out of range")
    emit({"phase": "granite_generate", "ok": True, "gpu": gpu,
          "requests": n_req, "prompt": plen, "gen_tokens": gen_tokens,
          "mode": out.mode, "prefill_ms": out.prefill_s * 1e3,
          "prefill_tokens_per_s": n_req * plen / out.prefill_s,
          "decode_ms": out.decode_s * 1e3,
          "decode_tokens_per_s": n_req * gen_tokens / out.decode_s,
          "flash_launches": fa.LAUNCHES, "swiglu_launches": sw.LAUNCHES,
          "swiglu_launches_by_variant": sw.LAUNCHES_BY_VARIANT,
          "first_request_tokens": toks[0].tolist()})
    del params
    torch.cuda.empty_cache()
    return flash_launches, sw_launches


# ---------------------------------------------------------------------------
# 13. granite-moe-1b-a400m fp32: kernel path on the card against the plain
# path, the routing compared exactly
# ---------------------------------------------------------------------------

def phase_granite_fp32_parity(torch, fa, sw):
    """Full width, depth 4, S = 640 > block_q so the flash kernel runs; one
    dispatch group of 640 tokens, capacity 200 per expert.  The plain path
    is the same weights on the CPU, where every wrapper runs its twin.
    Each layer's top-k mask is recorded on both paths and compared: a
    flipped expert choice would change a token's output by O(1)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(ARCHS["granite-moe-1b-a400m"],
                              attention_impl="pallas", dtype="float32",
                              n_layers=4)
    model = build_model(cfg)
    params = model.init(0)
    g = torch.Generator("cuda").manual_seed(31)
    tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                           device="cuda")
    masks = []
    top_k_mask = moe._top_k_mask

    def recorded(probs, k):
        mask, weights = top_k_mask(probs, k)
        masks.append(mask.cpu())
        return mask, weights

    moe._top_k_mask = recorded
    try:
        _zero(fa, sw)
        with torch.no_grad():
            got = model.forward(params, {"tokens": tokens}).cpu()
        launches = {"flash": fa.LAUNCHES, "swiglu": sw.LAUNCHES}
        fp32_only = _only(fa, "simt", cfg.n_layers) and \
            _only(sw, "simt", cfg.n_layers)
        params_cpu = copy.deepcopy(params).to("cpu")
        del params
        torch.cuda.empty_cache()
        card_masks, masks = masks, []
        t0 = time.perf_counter()
        with torch.no_grad():
            want = model.forward(params_cpu, {"tokens": tokens.cpu()})
        cpu_s = time.perf_counter() - t0
    finally:
        moe._top_k_mask = top_k_mask
    expected = {"flash": cfg.n_layers, "swiglu": cfg.n_layers}
    check(launches == expected and fp32_only, "granite_fp32_parity",
          f"kernel launches {launches}, expected {expected}, all fp32 "
          "(simt)")
    flipped = [int((a != b).any(-1).sum()) for a, b in zip(card_masks, masks)]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = (rel <= LOGITS_REL_TOL and bool(got.isfinite().all())
          and len(card_masks) == len(masks) == cfg.n_layers
          and not any(flipped))
    emit({"phase": "granite_fp32_parity", "ok": ok, "layers": cfg.n_layers,
          "batch": 1, "seq": 640, "kernel_launches": launches,
          "tokens_with_flipped_experts_per_layer": flipped,
          "max_rel_err": rel, "tol": LOGITS_REL_TOL,
          "plain_path_cpu_s": cpu_s})
    check(ok, "granite_fp32_parity",
          f"max_rel_err {rel}, flipped expert choices per layer {flipped}")


# ---------------------------------------------------------------------------
# 14. bf16: the card path (wgmma kernels) against the plain path
# ---------------------------------------------------------------------------

# depth of each model for the bf16 check: one group of zamba2-7b (6 mamba
# layers + the shared block, then a tail layer) and of xlstm-1.3b (7 mLSTM
# blocks + the sLSTM block)
BF16_PARITY = {"llama3.2-3b": 2, "zamba2-7b": 7, "granite-moe-1b-a400m": 4,
               "xlstm-1.3b": 8}
# xlstm-1.3b's gated bf16 comparison is per mLSTM block (these three): its
# logits at depth 8 move by ~0.1 normwise between two correct fp32 mLSTM
# implementations (its twin and the simt kernel, both on the card), so the
# model-level number is reported beside the same number for the twin
XLSTM_BF16_BLOCKS = (0, 3, 6)
# max|a-b| / max|b|: the CPU bf16 model tests' normwise bound (bf16 rounds
# after each op in another order on the card: the wgmma kernels keep P and
# h in bf16, cuBLAS and the CPU sum in other orders)
BF16_REL_TOL = 2e-2


def bf16_launches(cfg):
    """{kernel: launches} of one forward of ``cfg``: all wgmma in bf16."""
    from repro_torch.models.transformer import xlstm_layout
    from repro_torch.models.zamba import layout

    if cfg.family == "hybrid":
        groups = layout(cfg)[0]
        return {"ssd": cfg.n_layers, "flash": groups, "swiglu": groups}
    if cfg.family == "ssm":
        groups, per = xlstm_layout(cfg)
        return {"mlstm": groups * per}
    return {"flash": cfg.n_layers, "swiglu": cfg.n_layers}


def phase_bf16_parity(torch, fa, ssd, ml, sw):
    """Each model at full width and reduced depth (``BF16_PARITY``) in
    bf16, S = 640 > block_q so flash runs and the last SSD or mLSTM chunk
    is ragged: the logits of the card path, every kernel launch under its
    wgmma variant, against the plain path (the same weights on the CPU,
    where every wrapper runs its twin), normwise within ``BF16_REL_TOL``.
    granite-moe's routing: the CPU path replays the card's expert choices,
    so the logits compare the arithmetic, and the choices the CPU path
    would have made differently are counted.  xlstm-1.3b is gated per mLSTM
    block (``XLSTM_BF16_BLOCKS``, the block's output at full width and
    S = 640); its logits are reported beside those of the same card path
    with the mLSTM kernel's plain twin in its place."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.models import moe, xlstm
    from repro_torch.models.model import build_model

    mods = {"flash": fa, "ssd": ssd, "mlstm": ml, "swiglu": sw}
    results = []
    top_k_mask = moe._top_k_mask
    for arch, depth in BF16_PARITY.items():
        cfg = dataclasses.replace(ARCHS[arch], attention_impl="pallas",
                                  dtype="bfloat16", n_layers=depth)
        model = build_model(cfg)
        params = model.init(0)
        g = torch.Generator("cuda").manual_seed(37)
        tokens = torch.randint(0, cfg.vocab, (1, 640), generator=g,
                               device="cuda")
        card_masks, cpu_masks = [], []
        replay = []              # set once the card path has run

        def recorded(probs, k):
            mask, weights = top_k_mask(probs, k)
            if not replay:
                card_masks.append(mask.cpu())
                return mask, weights
            card = card_masks[len(cpu_masks)].to(mask.dtype)
            cpu_masks.append(mask)
            w = probs * card
            return card, w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)

        moe._top_k_mask = recorded
        try:
            _zero(*mods.values())
            with torch.no_grad():
                got = model.forward(params, {"tokens": tokens}).float().cpu()
            launches = {n: dict(m.LAUNCHES_BY_VARIANT)
                        for n, m in mods.items()}
            expected = bf16_launches(cfg)
            launches_ok = all(_only(m, "wgmma", expected.get(n, 0))
                              for n, m in mods.items())
            params_cpu = copy.deepcopy(params).to("cpu")
            if cfg.family == "ssm":
                twin_got = _with_mlstm_twin(
                    torch, mlstm_ops, ml,
                    lambda: model.forward(params, {"tokens": tokens}))
                layer_rels = _xlstm_layer_rels(torch, xlstm, cfg, params,
                                               params_cpu)
            del params
            torch.cuda.empty_cache()
            replay.append(True)
            t0 = time.perf_counter()
            with torch.no_grad():
                want = model.forward(params_cpu,
                                     {"tokens": tokens.cpu()}).float()
            cpu_s = time.perf_counter() - t0
        finally:
            moe._top_k_mask = top_k_mask
        rel = ((got - want).abs().max() / want.abs().max()).item()
        flipped = [int((a != b).any(-1).sum())
                   for a, b in zip(card_masks, cpu_masks)]
        row = {"arch": arch, "layers": depth, "seq": 640,
               "launches_by_variant": launches, "expected": expected,
               "max_rel_err": rel, "tol": BF16_REL_TOL,
               "plain_path_cpu_s": cpu_s}
        if cfg.family == "moe":
            row["tokens_with_flipped_experts_per_layer"] = flipped
        gated = rel
        if cfg.family == "ssm":
            row["logits_gated"] = False
            row["mlstm_twin_on_card_max_rel_err"] = (
                (twin_got - want).abs().max() / want.abs().max()).item()
            row["kernel_vs_twin_on_card_max_rel_err"] = (
                (got - twin_got).abs().max() / twin_got.abs().max()).item()
            row["mlstm_block_max_rel_err"] = dict(zip(
                map(str, XLSTM_BF16_BLOCKS), layer_rels))
            gated = max(layer_rels)
        results.append(row)
        del params_cpu, got, want
        check(launches_ok, "bf16_parity",
              f"{arch}: kernel launches {launches}, expected {expected} "
              "all wgmma")
        check(gated <= BF16_REL_TOL, "bf16_parity",
              f"{arch}: max_rel_err {gated} ({row})")
    emit({"phase": "bf16_parity", "ok": True, "results": results})


# ---------------------------------------------------------------------------
# 15-16. the paper's path: LayerGraph -> compile_plan -> replay -> grads
# ---------------------------------------------------------------------------

def _graph_batch(torch, g, batch, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    shape = (batch,) + tuple(g.input_shape)
    if any(l.kind == "embedding" for l in g.layers):
        x = torch.randint(0, 50, shape, generator=gen, device="cuda")
    else:
        x = torch.randn(shape, generator=gen, device="cuda")
    y = torch.randn((batch,) + tuple(g.label_shape), generator=gen,
                    device="cuda")
    if g.layers[-1].kind == "loss_ce":
        y = torch.nn.functional.one_hot(
            y.argmax(-1), y.shape[-1]).to(torch.float32)
    return x, y


def _grad_errs(torch, got, want):
    """(elementwise within GRAD_TOL, max abs err, max normwise err) over
    every gradient tensor."""
    ok = sorted(got) == sorted(want) and all(
        sorted(got[k]) == sorted(want[k]) for k in want)
    max_abs = max_rel = 0.0
    for k in want:
        for n, b in want[k].items():
            a = got[k][n]
            err = (a - b).abs()
            top = b.abs().max().item()
            ok &= bool((err <= GRAD_TOL["atol"] * max(1.0, top)
                        + GRAD_TOL["rtol"] * b.abs()).all())
            e = err.max().item()
            max_abs = max(max_abs, e)
            max_rel = max(max_rel, e / top if top else e)
    return ok, max_abs, max_rel


def _max_abs_err(got, want):
    return max((got[k][n].double() - b.double()).abs().max().item()
               for k in want for n, b in want[k].items())


def _fp64_grads(torch, reference_loss_and_grads, g, params, x, y):
    """The exact gradients' stand-in: autograd over the graph in fp64."""
    params = {k: {n: v.double() for n, v in p.items()}
              for k, p in params.items()}
    if x.is_floating_point():
        x = x.double()
    return reference_loss_and_grads(g, params, x, y.double())[1]


def _timed_step(torch, cp, params, x, y, executor):
    """One replay: (loss, grads, stats, wall s, allocator peak over what was
    allocated before it, parameters and inputs among that)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, grads, stats = cp.loss_and_grads(params, x, y, executor=executor)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return loss, grads, stats, wall, torch.cuda.max_memory_allocated() - base


def _paper_row(graph, backend, plan, cp, stats, wall, loss, **extra):
    """One row of the paper path's table (floats to 4 significant
    digits: the line must fit the end of the output)."""
    def r(v):
        return float(f"{v:.4g}") if isinstance(v, float) else v
    row = {"graph": graph, "backend": backend, "plan": plan,
           "step_s": wall, "loss": float(loss),
           "swap_outs": stats.swap_outs, "dma_bytes": stats.dma_bytes,
           "hbm_high_water": stats.hbm_high_water,
           "late_swap_ins": stats.late_swap_ins, "fences": stats.fences,
           "stalled_fences": stats.stalled_fences,
           "achieved_overlap": stats.achieved_overlap,
           "hidden_dma_s": stats.hidden_dma_s,
           "exposed_dma_s": stats.exposed_dma_s,
           "inflight_high_water": stats.inflight_high_water,
           "peak_inflight_prefetch": stats.peak_inflight_prefetch, **extra}
    return {k: r(v) for k, v in row.items()}


def phase_paper_zoo(torch, gpu):
    from repro_torch.core.exec.layers import reference_loss_and_grads
    from repro_torch.core.plan import MemoryPlanConfig, compile_plan
    from repro_torch.core.zoo import ZOO

    rows = []
    t_phase = time.perf_counter()
    for i, name in enumerate(sorted(ZOO)):
        g = ZOO[name]()
        cp = compile_plan(g, MemoryPlanConfig(**PAPER_EXEC),
                          batch=PAPER_ZOO_BATCH)
        params = cp.init_params(torch.Generator("cuda").manual_seed(i))
        x, y = _graph_batch(torch, g, PAPER_ZOO_BATCH, 100 + i)
        ref_loss, ref_grads = reference_loss_and_grads(g, params, x, y)
        exact = _fp64_grads(torch, reference_loss_and_grads, g, params, x, y)
        ref_err_fp64 = _max_abs_err(ref_grads, exact)
        got = {}
        for backend in ("sim", "async"):
            loss, grads, stats, wall, _ = _timed_step(
                torch, cp, params, x, y, backend)
            ok, max_abs, max_rel = _grad_errs(torch, grads, ref_grads)
            loss_err = abs(loss.item() - ref_loss.item())
            where = f"{name} on {backend}"
            check(stats.replayed_ops == cp.lowered.ops, "paper_zoo",
                  f"{where}: the replay left the compiled op list")
            check(stats.late_swap_ins == 0, "paper_zoo",
                  f"{where}: {stats.late_swap_ins} late swap-ins")
            check(stats.hbm_high_water <= cp.plan.activation_residency_peak(),
                  "paper_zoo", f"{where}: high water {stats.hbm_high_water} "
                  "over the planned residency peak")
            # the lowered transfers' bytes: cp.dma_bytes also counts the
            # swaps of S: scratch tensors, which stay plan-level (no op)
            lowered_dma = sum(op.nbytes for op in cp.lowered.transfers())
            check(stats.dma_bytes == lowered_dma, "paper_zoo",
                  f"{where}: {stats.dma_bytes} DMA bytes, lowered "
                  f"{lowered_dma}")
            check(ok and max_rel <= GRAD_NORM_TOL
                  and loss_err <= 1e-4 * abs(ref_loss.item()) + 1e-5,
                  "paper_zoo", f"{where}: grads max abs err {max_abs} "
                  f"(normwise {max_rel}), loss err {loss_err}")
            got[backend] = stats
            rows.append(_paper_row(name, backend, "swap", cp, stats, wall,
                                   loss, grad_err=max_abs,
                                   grad_norm_err=max_rel,
                                   grad_err_fp64=_max_abs_err(grads, exact),
                                   ref_grad_err_fp64=ref_err_fp64))
        for field in PAIRED_STATS:
            check(getattr(got["sim"], field) == getattr(got["async"], field),
                  "paper_zoo", f"{name}: {field} differs between sim "
                  f"({getattr(got['sim'], field)}) and async "
                  f"({getattr(got['async'], field)})")
        del params, ref_grads, grads, exact
        torch.cuda.empty_cache()
    emit({"phase": "paper_zoo", "ok": True, "gpu": gpu,
          "graphs": len(ZOO), "batch": PAPER_ZOO_BATCH,
          "transfers": sum(2 * r["swap_outs"] for r in rows
                           if r["backend"] == "async"),
          "wall_s": time.perf_counter() - t_phase})
    return rows


def phase_paper_trunk(torch, gpu):
    from repro_torch.core.exec.backends import AsyncDeviceBackend
    from repro_torch.core.exec.layers import (reference_loss_and_grads,
                                              sgd_update)
    from repro_torch.core.plan import MemoryPlanConfig, compile_plan
    from repro_torch.core.zoo import transformer_mlp_stack

    g = transformer_mlp_stack()
    t0 = time.perf_counter()
    cp = compile_plan(g, MemoryPlanConfig(), batch=TRUNK_BATCH)
    cp_flat = compile_plan(g, MemoryPlanConfig(swap=False), batch=TRUNK_BATCH)
    compile_s = time.perf_counter() - t0
    params = cp.init_params(torch.Generator("cuda").manual_seed(5))
    x, y = _graph_batch(torch, g, TRUNK_BATCH, 6)
    # He init doubles the variance through each up/down pair (the down
    # projection has no activation), 2^28 over the trunk: inputs at std
    # 2^-14 reach the MSE head at unit scale, so SGD steps stay finite
    n_pairs = sum(l.kind == "linear" for l in g.layers) // 2
    x = x * 2.0 ** (-n_pairs / 2)
    ref_loss, ref_grads = reference_loss_and_grads(g, params, x, y)
    torch.cuda.empty_cache()
    rows = []

    def held(where, plan, stats, grads, loss):
        ok, max_abs, max_rel = _grad_errs(torch, grads, ref_grads)
        check(stats.replayed_ops == plan.lowered.ops, "paper_trunk",
              f"{where}: the replay left the compiled op list")
        check(stats.late_swap_ins == 0, "paper_trunk",
              f"{where}: {stats.late_swap_ins} late swap-ins")
        check(ok and max_rel <= GRAD_NORM_TOL, "paper_trunk",
              f"{where}: step-1 grads max abs err {max_abs}, normwise "
              f"{max_rel}")
        check(abs(loss.item() - ref_loss.item())
              <= 1e-4 * abs(ref_loss.item()), "paper_trunk",
              f"{where}: loss {loss.item()} against {ref_loss.item()}")
        return dict(grad_err=max_abs, grad_norm_err=max_rel)

    # the no-swap plan (after one untimed warm-up step), then sim, then
    # async: step 1 from the same params
    cp_flat.loss_and_grads(params, x, y, executor="async")
    loss, grads, stats, wall, flat_peak = _timed_step(
        torch, cp_flat, params, x, y, "async")
    errs = held("no-swap plan", cp_flat, stats, grads, loss)
    rows.append(_paper_row("transformer_mlp_stack", "async", "no_swap",
                           cp_flat, stats, wall, loss, step=1,
                           measured_peak_bytes=flat_peak, **errs))
    del grads
    loss, grads, stats, wall, sim_peak = _timed_step(
        torch, cp, params, x, y, "sim")
    errs = held("sim", cp, stats, grads, loss)
    rows.append(_paper_row("transformer_mlp_stack", "sim", "swap", cp, stats,
                           wall, loss, step=1, measured_peak_bytes=sim_peak,
                           **errs))
    del grads
    torch.cuda.empty_cache()

    backend = AsyncDeviceBackend()     # keeps its pinned pool across steps
    t0 = time.perf_counter()
    backend.make_engine(x.device).reserve(cp.host_pool_bytes)
    pin_s = time.perf_counter() - t0
    losses = []
    swap_peak = None
    for step in range(1, TRUNK_STEPS + 1):
        loss, grads, stats, wall, peak = _timed_step(
            torch, cp, params, x, y, backend)
        extra = {}
        if step == 1:
            swap_peak = peak
            extra = held("async", cp, stats, grads, loss)
            del ref_grads
        check(stats.replayed_ops == cp.lowered.ops
              and stats.late_swap_ins == 0, "paper_trunk",
              f"async step {step}: replay {stats.late_swap_ins} late")
        losses.append(loss.item())
        rows.append(_paper_row("transformer_mlp_stack", "async", "swap", cp,
                               stats, wall, loss, step=step,
                               measured_peak_bytes=peak, **extra))
        params = sgd_update(params, grads)
        del grads
    # one step's wall time spreads by tens of percent between steps, so
    # the swapped and the no-swap plan are compared by the medians of
    # steps taken in turns from the same params (ABBA order)
    walls = {"swap": [], "no_swap": []}
    last = {}
    for i in range(TRUNK_TIMED_ROUNDS):
        order = (("swap", cp, backend), ("no_swap", cp_flat, "async"))
        for plan, plan_cp, executor in order[::(-1) ** i]:
            loss, grads, stats, wall, _ = _timed_step(
                torch, plan_cp, params, x, y, executor)
            check(stats.replayed_ops == plan_cp.lowered.ops
                  and stats.late_swap_ins == 0, "paper_trunk",
                  f"timed {plan} step: {stats.late_swap_ins} late")
            walls[plan].append(wall)
            last[plan] = (plan_cp, stats, loss)
            del grads
    medians = {plan: statistics.median(w) for plan, w in walls.items()}
    for plan, (plan_cp, stats, loss) in last.items():
        rows.append(_paper_row("transformer_mlp_stack", "async", plan,
                               plan_cp, stats, medians[plan], loss,
                               step=f"median of {TRUNK_TIMED_ROUNDS}"))
    saved = flat_peak - swap_peak
    ok = saved >= cp.hbm_bytes_saved / 2 \
        and all(math.isfinite(v) for v in losses)
    emit({"phase": "paper_trunk", "ok": ok, "gpu": gpu,
          "batch": TRUNK_BATCH,
          "layers": sum(l.kind == "linear" for l in g.layers) // 2,
          "dtype": "float32",
          "tf32": False, "compile_s": compile_s,
          "planned_peak_bytes": cp.peak_bytes,
          "planned_no_swap_peak_bytes": cp_flat.peak_bytes,
          "planned_hbm_bytes_saved": cp.hbm_bytes_saved,
          "host_pool_bytes": cp.host_pool_bytes, "dma_bytes": cp.dma_bytes,
          "measured_peak_bytes": swap_peak,
          "measured_no_swap_peak_bytes": flat_peak,
          "measured_sim_peak_bytes": sim_peak,
          "measured_bytes_saved": saved, "pool_pin_s": pin_s,
          "losses": losses, "timed_step_s": walls,
          "median_step_s": medians,
          "swap_over_no_swap": medians["swap"] / medians["no_swap"]})
    check(all(math.isfinite(v) for v in losses), "paper_trunk",
          f"SGD losses {losses}")
    check(ok, "paper_trunk",
          f"measured peak fell by {saved} bytes, under half the planned "
          f"{cp.hbm_bytes_saved}")
    del params, x, y
    torch.cuda.empty_cache()
    return rows


def _with_mlstm_twin(torch, mlstm_ops, ml, forward):
    """``forward()`` with the mLSTM kernel's plain twin in its place, on the
    card (logits, on the CPU)."""
    kernel = mlstm_ops.mlstm_chunk
    mlstm_ops.mlstm_chunk = ml.mlstm_chunk_plain
    try:
        with torch.no_grad():
            return forward().float().cpu()
    finally:
        mlstm_ops.mlstm_chunk = kernel


def _xlstm_layer_rels(torch, xlstm, cfg, params, params_cpu):
    """max|a-b| / max|b| of each ``XLSTM_BF16_BLOCKS`` mLSTM block's output,
    the card (wgmma kernel) against the CPU (plain twin), on one seeded
    input of 640 rows at full width."""
    g = torch.Generator("cuda").manual_seed(41)
    x = torch.randn(1, 640, cfg.d_model, generator=g, device="cuda") \
        .to(torch.bfloat16)
    rels = []
    for blk in XLSTM_BF16_BLOCKS:
        with torch.no_grad():
            got = xlstm.mlstm_forward(cfg, params.mblocks[blk].mlstm, x)
            want = xlstm.mlstm_forward(cfg, params_cpu.mblocks[blk].mlstm,
                                       x.cpu()).float()
        rels.append(((got.float().cpu() - want).abs().max()
                     / want.abs().max()).item())
    return rels


if __name__ == "__main__":
    sys.exit(main())
