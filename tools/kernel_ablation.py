#!/usr/bin/env python3
"""Ablations of the wgmma flash-attention and fused-SwiGLU kernels on one
CUDA card.

    python3 tools/kernel_ablation.py

Each ablation is a copy of the kernel's source with one design choice
undone by a textual edit, built into ``build/ablation/`` with the port's
own nvcc flags, then timed in turns (as built, ablated, ablated, as built)
with CUDA events at the main paths' shapes, bf16:

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
  ``no_setmaxnreg``.

Every ablation that keeps the function is checked against the plain twin
at the bf16 tolerance.  For each build it prints ptxas' register, spill
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gpu = gpu.splitlines()[0]
    print(gpu, flush=True)
    fsrc = ablated_sources(fa.WGMMA_SOURCE, FLASH_ABLATIONS, "flash")
    ssrc = ablated_sources(sw.WGMMA_SOURCE, SWIGLU_ABLATIONS, "swiglu")
    sources = {**{("flash", n): p for n, p in fsrc.items()},
               **{("swiglu", n): p for n, p in ssrc.items()}}
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.load, sources.values())))
    for key, path in sources.items():
        log = _build.library_path(path).with_suffix(".log").read_text()
        emit({"build": list(key), "ptxas": [
            ln.split("info    : ")[-1] for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "serialized" in ln]})
    flash(torch, {n: libs[("flash", n)] for n in fsrc}, gpu)
    swiglu(torch, {n: libs[("swiglu", n)] for n in ssrc}, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
