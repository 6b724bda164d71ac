#!/usr/bin/env python3
"""Ablations of the wgmma kernels (flash attention, fused SwiGLU, SSD chunk,
mLSTM chunk) on one CUDA card.

    python3 tools/kernel_ablation.py

Each ablation is a copy of the kernel's source with one design choice
undone by a textual edit, built into ``build/ablation/`` with the port's
own nvcc flags, then timed in turns (as built, ablated, ablated, as built)
with CUDA events at the main paths' shapes:

- flash attention (llama3.2-3b D 128, zamba2-7b D 112, granite-moe D 64,
  B = 2, S = 4096, causal): ``no_pingpong`` (the warpgroups issue their
  products whenever ready), ``exp2f`` (the library's exp2f for the SFU's
  ex2.approx), ``block_n_112`` (112-key tiles at DP = 128: S, P and O no
  longer fit 168 registers and ptxas serialises the wgmmas),
  ``no_setmaxnreg``, ``always_rescale`` (O multiplied by the correction on
  every tile, also when no row's max moved); and two that give wrong
  outputs and only say where the
  time goes: ``no_softmax`` (P = S, no max, no exponentials) and
  ``no_kv_stream`` (the first K/V stages reused for every tile: no TMA
  traffic in the loop);
- fused SwiGLU (llama3.2-3b MLP, zamba2-7b shared MLP, granite-moe-1b-a400m
  experts): ``accurate_epilogue`` (expf and a true division in silu) and
  ``no_setmaxnreg``;
- SSD chunk, fp32 (zamba2-7b's mamba layer, B = 2, S = 4096):
  ``cbt_per_head_pair`` (2 heads a CTA instead of 8, one a warpgroup: C Bᵀ
  computed 4x as often) and ``single_tf32`` (one tf32 pass, hi_a hi_b,
  instead of three; the lo tiles are still stored);
- mLSTM chunk, fp32 (xlstm-1.3b's mLSTM layer, B = 2, S = 4096):
  ``w_through_device_memory`` (W written from shared memory to a device
  scratch and read back before W v, as the simt kernel's W goes) and
  ``single_tf32``.

Every ablation that keeps the function is checked against the plain twin
at its tolerance (bf16: 2e-2; SSD and mLSTM: 1e-4); the single tf32 pass
reports its error beside its time.  For each build it prints ptxas' register, spill
and wgmma-serialisation lines; for each shape one JSON line of times (ms)
beside the card's name and power limit.  Needs the card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

OUT_DIR = ROOT / "build" / "ablation"
TOL = dict(rtol=2e-2, atol=2e-2)          # tests/test_kernels.py, bf16
FP32_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py:105,151

SETMAXNREG_OFF = [("    setmaxnreg_dec<PRODUCER_REGS>();\n", ""),
                  ("    setmaxnreg_inc<CONSUMER_REGS>();\n", "")]
FLASH_ABLATIONS = {
    "no_pingpong": ([('asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) '
                      ': "memory");', "(void)wg;"),
                     ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg) '
                      ': "memory");', "(void)wg;")], True),
    "exp2f": ([("exp2_approx(", "exp2f(")], True),
    "block_n_112": ([("static constexpr int BN = DP == 64 ? 128 : 96;",
                      "static constexpr int BN = DP == 64 ? 128 : 112;")],
                    True),
    "no_setmaxnreg": (SETMAXNREG_OFF, True),
    "always_rescale": ([("    if (__all_sync(0xffffffffu, corr_lo == 1.f && "
                         "corr_hi == 1.f)) return;\n", "")], True),
    "no_softmax": ([("    sm.step(sc, 0, r, p, lane);\n", ""),
                    ("      sm.step(sc, n * BN, r, p, lane);\n", "")], False),
    "no_kv_stream": ([("      for (int n = 0; n < n_blocks; ++n) {\n"
                       "        const int s = n % STAGES;\n"
                       "        if (n >= STAGES)",
                       "      for (int n = 0; n < min(n_blocks, STAGES); "
                       "++n) {\n        const int s = n % STAGES;\n"
                       "        if (n >= STAGES)"),
                      ("      mbar_wait(bar_k(s), (n / STAGES) & 1);",
                       "      if (n < STAGES) mbar_wait(bar_k(s), 0);"),
                      ("      mbar_wait(bar_v(sp), ((n - 1) / STAGES) & 1);",
                       "      if (n - 1 < STAGES) mbar_wait(bar_v(sp), 0);"),
                      ("    mbar_wait(bar_v(sl), ((n_blocks - 1) / STAGES) "
                       "& 1);",
                       "    if (n_blocks - 1 < STAGES) "
                       "mbar_wait(bar_v(sl), 0);")], False),
}
SWIGLU_ABLATIONS = {
    "accurate_epilogue": ([("return __fdividef(g, 1.0f + __expf(-g)) * u;",
                            "return g / (1.0f + expf(-g)) * u;")], True),
    "no_setmaxnreg": (SETMAXNREG_OFF, True),
}
SSD_ABLATIONS = {
    "cbt_per_head_pair": ([("constexpr int HEADS = 8;",
                            "constexpr int HEADS = 2;")], True),
    "single_tf32": ([("""    wgmma_tf32_n64(acc, desc_k_major(a_lo + off), desc_k_major(b_hi + off),
                   !(overwrite && s == 0));
    wgmma_tf32_n64(acc, desc_k_major(a_hi + off), desc_k_major(b_lo + off),
                   1);
""", ""), ("""    wgmma_tf32_n64(acc, desc_k_major(a_hi + off), desc_k_major(b_hi + off),
                   1);""", """    wgmma_tf32_n64(acc, desc_k_major(a_hi + off), desc_k_major(b_hi + off),
                   !(overwrite && s == 0));""")], False),
}
MLSTM_W_ROUND_TRIP = """
  // ablation: W through device memory and back
  {
    __syncthreads();
    constexpr int N4 = 16 * ATOM64 / 16;
    float4* g = reinterpret_cast<float4*>(w_scratch) +
                size_t(blockIdx.x) * N4;
    float4* s4 = reinterpret_cast<float4*>(sm + W_HI);
    for (int i = t; i < N4; i += THREADS) __stcg(g + i, s4[i]);
    __syncthreads();
    for (int i = t; i < N4; i += THREADS) s4[i] = __ldcg(g + i);
  }

  // ---- y = W v: 128-column slices of v, each warpgroup 64 of them -------"""
MLSTM_ABLATIONS = {
    "w_through_device_memory": ([
        ("using namespace hopper;\n",
         "using namespace hopper;\n__device__ float w_scratch[512 * 16 * 64 "
         "* 128 / 4];\n"),
        ("\n  // ---- y = W v: 128-column slices of v, each warpgroup 64 of "
         "them -------", MLSTM_W_ROUND_TRIP)], True),
    "single_tf32": ([
        ("""  wgmma_tf32_n64(acc, desc_k_major(a_lo), desc_k_major(b_hi), accumulate);
  wgmma_tf32_n64(acc, desc_k_major(a_hi), desc_k_major(b_lo), 1);
  wgmma_tf32_n64(acc, desc_k_major(a_hi), desc_k_major(b_hi), 1);""",
         """  wgmma_tf32_n64(acc, desc_k_major(a_hi), desc_k_major(b_hi), accumulate);"""),
        ("""      wgmma_tf32_n128(acc, desc_k_major(sb + A_LO + a_off),
                      desc_k_major(sb + B_HI + b_off), a > 0 || k8 > 0);
      wgmma_tf32_n128(acc, desc_k_major(sb + A_HI + a_off),
                      desc_k_major(sb + B_LO + b_off), 1);
      wgmma_tf32_n128(acc, desc_k_major(sb + A_HI + a_off),
                      desc_k_major(sb + B_HI + b_off), 1);""",
         """      wgmma_tf32_n128(acc, desc_k_major(sb + A_HI + a_off),
                      desc_k_major(sb + B_HI + b_off), a > 0 || k8 > 0);""")],
                    False),
}
FLASH_SHAPES = {"llama3.2-3b": (2, 24, 8, 4096, 128),
                "zamba2-7b": (2, 32, 32, 4096, 112),
                "granite-moe-1b-a400m": (2, 16, 8, 4096, 64)}
SWIGLU_SHAPES = {"llama3.2-3b MLP": (1, 8192, 3072, 8192),
                 "zamba2-7b shared MLP": (1, 8192, 3584, 14336),
                 "granite-moe-1b-a400m experts": (32, 2560, 1024, 512)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ablated_sources(source: Path, ablations: dict, tag: str) -> dict:
    """{name: path} of the source as built and each ablated copy."""
    text = source.read_text()
    out = {"as_built": source}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, (edits, _) in ablations.items():
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"{source.name}: ablation {name} no longer "
                                 f"applies ({old.strip()[:60]!r})")
            t = t.replace(old, new)
        path = OUT_DIR / f"{tag}_{name}.cu"
        path.write_text(t)
        out[name] = path
    return out


def median_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def in_turns(torch, fns: dict, reps: int) -> dict:
    """Each fn's time: the lesser of two medians taken in turns (a, b, ...,
    ..., b, a)."""
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(median_ms(torch, fns[n], reps))
    return {n: min(t) for n, t in times.items()}


def max_err(torch, got, want):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= TOL["atol"] + TOL["rtol"] * want.float().abs()).all())
    return err.max().item(), ok


def flash(torch, libs, gpu):
    from repro_torch.kernels.flash_attention import kernel as fa

    for lib in libs.values():
        lib.flash_attention_fwd_wgmma.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def run(lib, q, k, v):
        out = torch.empty_like(q)
        b, hq, s, d = q.shape
        strides = (ctypes.c_longlong * 12)(
            *(x for t in (q, k, v, out) for x in t.stride()[:3]))
        err = lib.flash_attention_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            strides, b, hq, k.shape[1], s, k.shape[2], d,
            1.0 / math.sqrt(d), 1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    g = torch.Generator("cuda").manual_seed(0)
    for arch, (b, hq, hkv, s, d) in FLASH_SHAPES.items():
        q = torch.randn(b, hq, s, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, hkv, s, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, hkv, s, d, generator=g, device="cuda").bfloat16()
        want = fa.flash_attention_fwd_plain(q, k, v)
        errs = {}
        for name, lib in libs.items():
            keeps = name == "as_built" or FLASH_ABLATIONS[name][1]
            if keeps:
                errs[name], ok = max_err(torch, run(lib, q, k, v), want)
                if not ok:
                    raise SystemExit(f"flash {name} {arch}: max abs err "
                                     f"{errs[name]}")
        times = in_turns(torch, {n: (lambda lib=lib: run(lib, q, k, v))
                                 for n, lib in libs.items()}, reps=10)
        flops = 4 * d * b * hq * s * (s + 1) // 2
        emit({"kernel": "flash_attention_fwd", "variant": "wgmma",
              "arch": arch, "shape": [b, hq, hkv, s, s, d, True],
              "gpu": gpu, "ms": times, "max_abs_err": errs,
              "tflops": {n: flops / t / 1e9 for n, t in times.items()}})
        del q, k, v, want
        torch.cuda.empty_cache()


def swiglu(torch, libs, gpu):
    from repro_torch.kernels.fused_swiglu import kernel as sw

    for lib in libs.values():
        lib.fused_swiglu_fwd_wgmma.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def run(lib, x, wg, wu):
        e, m, k = x.shape
        h = torch.empty(e, m, wg.shape[-1], dtype=x.dtype, device=x.device)
        err = lib.fused_swiglu_fwd_wgmma(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(), e, m,
            k, wg.shape[-1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return h

    g = torch.Generator("cuda").manual_seed(1)
    for path, (e, m, k, f) in SWIGLU_SHAPES.items():
        x = (torch.randn(e, m, k, generator=g, device="cuda") * 0.5) \
            .bfloat16()
        wg = (torch.randn(e, k, f, generator=g, device="cuda") * 0.05) \
            .bfloat16()
        wu = (torch.randn(e, k, f, generator=g, device="cuda") * 0.05) \
            .bfloat16()
        want = sw.fused_swiglu_plain(x, wg, wu)
        errs = {}
        for name, lib in libs.items():
            errs[name], ok = max_err(torch, run(lib, x, wg, wu), want)
            if not ok:
                raise SystemExit(f"swiglu {name} {path}: max abs err "
                                 f"{errs[name]}")
        times = in_turns(torch, {n: (lambda lib=lib: run(lib, x, wg, wu))
                                 for n, lib in libs.items()}, reps=20)
        flops = 4 * e * m * k * f
        emit({"kernel": "fused_swiglu", "variant": "wgmma", "path": path,
              "shape": [e, m, k, f], "gpu": gpu, "ms": times,
              "max_abs_err": errs,
              "tflops": {n: flops / t / 1e9 for n, t in times.items()}})
        del x, wg, wu, want
        torch.cuda.empty_cache()


def _fp32_err(got, want):
    """(max |got - want|, max of it over the fp32 tolerance) over the
    outputs."""
    errs = [(g - w).abs() for g, w in zip(got, want)]
    return (max(e.max().item() for e in errs),
            max((e / (FP32_TOL["atol"] + FP32_TOL["rtol"] * w.abs()))
                .max().item() for e, w in zip(errs, want)))


def _scan_ablations(torch, libs, ablations, run, ins, want, kernel, shape,
                    gpu, reps):
    """Errors against the twin (a build that keeps the function must meet
    the fp32 tolerance), then the times in turns; one JSON line."""
    errs, shares = {}, {}
    for name, lib in libs.items():
        errs[name], shares[name] = _fp32_err(run(lib, ins), want)
        if (name == "as_built" or ablations[name][1]) and shares[name] > 1:
            raise SystemExit(f"{kernel} {name}: max abs err {errs[name]}")
    times = in_turns(torch, {n: (lambda lib=lib: run(lib, ins))
                             for n, lib in libs.items()}, reps=reps)
    emit({"kernel": kernel, "variant": "wgmma", "shape": shape, "gpu": gpu,
          "ms": times, "max_abs_err": errs, "err_over_tol": shares})


def ssd(torch, libs, gpu):
    from repro_torch.kernels.ssm_scan import kernel as S
    from repro_torch.kernels.ssm_scan.ops import chunk_inputs

    for lib in libs.values():
        lib.ssd_chunk_fwd_wgmma.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def run(lib, ins):
        x, dt, A_log, B, C = ins
        b, nc, q, h, p = x.shape
        n = B.shape[-1]
        outs = (torch.empty_like(x),
                torch.empty(b, nc, h, n, p, device="cuda"),
                torch.empty(b, nc, h, device="cuda"))
        err = lib.ssd_chunk_fwd_wgmma(
            *(t.data_ptr() for t in ins + outs), b * nc, q, h, n, p,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return outs

    b, s, h, p, n, chunk = 2, 4096, 112, 64, 64, 256     # zamba2-7b
    g = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(b, s, h, p, generator=g, device="cuda")
    B = torch.randn(b, s, n, generator=g, device="cuda")
    C = torch.randn(b, s, n, generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=g, device="cuda"))
    A_log = torch.randn(h, generator=g, device="cuda") * 0.5
    xc, dtc, Bc, Cc = chunk_inputs(x, dt, B, C, chunk)
    ins = (xc, dtc, A_log, Bc, Cc)
    _scan_ablations(torch, libs, SSD_ABLATIONS, run, ins,
                    S.ssd_chunk_plain(*ins), "ssd_chunk",
                    [b, s, h, p, n, chunk], gpu, reps=20)


def mlstm(torch, libs, gpu):
    from repro_torch.kernels.mlstm_scan import kernel as M
    from repro_torch.kernels.mlstm_scan.ops import chunk_inputs

    for lib in libs.values():
        lib.mlstm_chunk_fwd_wgmma.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])

    def run(lib, ins):
        q, k, v, li, lf, scale = ins
        b, nc, nq, h, p = q.shape
        f32 = dict(device="cuda")
        outs = (torch.empty_like(q), torch.empty(b, nc, nq, h, **f32),
                torch.empty(b, nc, nq, h, **f32),
                torch.empty(b, nc, h, p, p, **f32),
                torch.empty(b, nc, h, p, **f32), torch.empty(b, nc, h, **f32),
                torch.empty(b, nc, h, **f32))
        err = lib.mlstm_chunk_fwd_wgmma(
            *(t.data_ptr() for t in ins[:5] + outs), b * nc * h, nq, h, p,
            scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return outs

    b, s, h, p, chunk = 2, 4096, 4, 1024, 256              # xlstm-1.3b
    g = torch.Generator("cuda").manual_seed(3)
    q, k, v = (torch.randn(b, s, h, p, generator=g, device="cuda")
               for _ in range(3))
    ig = torch.randn(b, s, h, generator=g, device="cuda") * 2
    fg = torch.randn(b, s, h, generator=g, device="cuda") * 2 + 2
    ins = (*chunk_inputs(q, k, v, ig, fg, chunk), 1 / math.sqrt(p))
    _scan_ablations(torch, libs, MLSTM_ABLATIONS, run, ins,
                    M.mlstm_chunk_plain(*ins), "mlstm_chunk",
                    [b, s, h, p, chunk], gpu, reps=10)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default="flash,swiglu,ssd,mlstm",
                        help="comma-separated kernels to ablate")
    only = parser.parse_args().only.split(",")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw
    from repro_torch.kernels.mlstm_scan import kernel as ml_k
    from repro_torch.kernels.ssm_scan import kernel as ssd_k

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = gpu.splitlines()[0]
    print(gpu, flush=True)
    srcs = {"flash": ablated_sources(fa.WGMMA_SOURCE, FLASH_ABLATIONS,
                                     "flash"),
            "swiglu": ablated_sources(sw.WGMMA_SOURCE, SWIGLU_ABLATIONS,
                                      "swiglu"),
            "ssd": ablated_sources(ssd_k.WGMMA_SOURCE, SSD_ABLATIONS, "ssd"),
            "mlstm": ablated_sources(ml_k.WGMMA_SOURCE, MLSTM_ABLATIONS,
                                     "mlstm")}
    sources = {(k, n): p for k, s in srcs.items() if k in only
               for n, p in s.items()}
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.load, sources.values())))
    for key, path in sources.items():
        log = _build.library_path(path).with_suffix(".log").read_text()
        emit({"build": list(key), "ptxas": [
            ln.split("info    : ")[-1] for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "serialized" in ln]})
    for kernel, fn in (("flash", flash), ("swiglu", swiglu), ("ssd", ssd),
                       ("mlstm", mlstm)):
        if kernel in only:
            fn(torch, {n: libs[(kernel, n)] for n in srcs[kernel]}, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
