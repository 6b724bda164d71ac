"""The card's roofline denominators: its data-sheet peaks, and a measure of
the rates it reaches.

The card's half of ``repro/launch/mesh.py``: the TPU constants are not
carried over (the mesh itself is ``launch/mesh.py``).  :data:`PEAKS`
holds each supported card's published dense peaks, keyed by
``torch.cuda.get_device_name()``; :func:`peaks` looks a card up and
raises for one it does not know (a roofline against a guessed peak would
be a number from nowhere).  :func:`measure` times what the card reaches
on the two operations that bound it: a bf16 cuBLAS GEMM and a
device-to-device copy.

    python -m repro_torch.launch.hw          # the card's peaks and rates
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """Published dense peaks of one card (no sparsity) at its full power
    limit.  ``flops`` by operand type: bfloat16 on the tensor cores,
    tfloat32 on the tensor cores (the rate of each pass of a 3xTF32
    product), float32 on the CUDA cores.  ``link_bytes_per_s`` is the
    rate of the card's links to its peers in one direction: the
    denominator of a mesh's collective term."""
    flops: Dict[str, float]
    hbm_bytes_per_s: float
    hbm_bytes: float
    link_bytes_per_s: float


# NVIDIA H100 SXM5 data sheet, at 700 W; NVLink 4: 18 links, 900 GB/s
# in both directions together, so 450 GB/s a direction
H100_SXM = CardPeaks(
    flops={"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12},
    hbm_bytes_per_s=3.35e12, hbm_bytes=80e9, link_bytes_per_s=450e9)

PEAKS: Dict[str, CardPeaks] = {"NVIDIA H100 80GB HBM3": H100_SXM}

# the port's card: the denominators of every bound the port reports
PEAK_FLOPS = H100_SXM.flops
HBM_BYTES_PER_S = H100_SXM.hbm_bytes_per_s
HBM_BYTES = H100_SXM.hbm_bytes
LINK_BYTES_PER_S = H100_SXM.link_bytes_per_s


def peaks(name: Optional[str] = None) -> CardPeaks:
    """The peaks of the card called ``name`` (by default, CUDA card 0's
    ``torch.cuda.get_device_name``).  An unknown card raises."""
    if name is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to look up; pass the card's "
                               "name")
        name = torch.cuda.get_device_name(0)
    try:
        return PEAKS[name]
    except KeyError:
        raise KeyError(f"no published peaks for card {name!r}; known: "
                       f"{sorted(PEAKS)}") from None


def bound_ms(flops: float, nbytes: float, dtype_name: str,
             card: CardPeaks = H100_SXM) -> Tuple[float, str]:
    """The least time (ms) ``card`` needs for ``flops`` operations of
    ``dtype_name`` moving ``nbytes`` through HBM: the larger of the two
    terms, and which one it is ("operations" or "bytes")."""
    t_ops = flops / card.flops[dtype_name]
    t_bytes = nbytes / card.hbm_bytes_per_s
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


GEMM_N = 8192
COPY_BYTES = 4 << 30


def _median_ms(torch, fn, reps: int, inner: int) -> float:
    fn()                                   # warm up (cuBLAS heuristics)
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


def measure(device=None, *, reps: int = 7) -> Dict:
    """What the card reaches, beside its data-sheet peaks: an
    ``GEMM_N``-cubed bf16 ``torch.matmul`` (cuBLAS; 2 N^3 operations) and
    a ``COPY_BYTES`` device-to-device ``copy_`` (each byte read once and
    written once), each the median of ``reps`` CUDA-event timings.  Needs
    the card: a CPU device raises."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("measure() times the CUDA card; it has no CPU "
                           "meaning")
    name = torch.cuda.get_device_name(dev)
    card = peaks(name)
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn(GEMM_N, GEMM_N, generator=g, device=dev,
                    dtype=torch.bfloat16)
    b = torch.randn(GEMM_N, GEMM_N, generator=g, device=dev,
                    dtype=torch.bfloat16)
    c = torch.empty(GEMM_N, GEMM_N, device=dev, dtype=torch.bfloat16)
    gemm_ms = _median_ms(torch, lambda: torch.matmul(a, b, out=c), reps, 5)
    del a, b, c
    src = torch.empty(COPY_BYTES, device=dev, dtype=torch.uint8)
    src.fill_(1)
    dst = torch.empty_like(src)
    copy_ms = _median_ms(torch, lambda: dst.copy_(src), reps, 3)
    del src, dst
    gemm_rate = 2 * GEMM_N ** 3 / (gemm_ms * 1e-3)
    copy_rate = 2 * COPY_BYTES / (copy_ms * 1e-3)
    return {"device": name,
            "gemm_bf16": {"n": GEMM_N, "ms": gemm_ms,
                          "flops_per_s": gemm_rate,
                          "peak_flops_per_s": card.flops["bfloat16"],
                          "of_peak": gemm_rate / card.flops["bfloat16"]},
            "copy": {"bytes": COPY_BYTES, "ms": copy_ms,
                     "bytes_per_s": copy_rate,
                     "peak_bytes_per_s": card.hbm_bytes_per_s,
                     "of_peak": copy_rate / card.hbm_bytes_per_s}}


def main() -> None:
    print(json.dumps(measure(), indent=2))


if __name__ == "__main__":
    main()
