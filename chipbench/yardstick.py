"""The benchmark's yardstick: the card's published peaks, the least time
each hand-written kernel's call needs, and the model FLOPs of a train step.

Frozen here so that a change to the program cannot move the denominators
it is measured against.  Each bound counts every input byte read once and
every output byte written once, and the operations the call's shapes need
(the pairs a causal mask keeps, not the tiles a kernel happens to visit).

Origins (copied, then kept apart from the program):

* ``PEAKS``: ``src/repro_torch/launch/hw.py`` ``H100_SXM`` (NVIDIA H100 SXM5
  data sheet, dense, at 700 W);
* ``bound_ms``: ``src/repro_torch/launch/hw.py`` ``bound_ms``;
* ``flash_launch``, ``ssd_launch``, ``swiglu_launch``:
  ``src/repro_torch/launch/costs.py``, the functions behind
  ``chip_smoke.py``'s ``flash_bound``, ``ssd_bound`` and ``swiglu_bound``.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM5 data sheet at 700 W, dense (no sparsity): operations a
# second by operand type (tfloat32: the rate of each pass of a 3xTF32
# product), HBM bytes a second, HBM bytes.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tfloat32": 495e12,
                              "float32": 67e12, "hbm_bytes_per_s": 3.35e12,
                              "hbm_bytes": 80e9},
}

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def peaks(card: str) -> Dict[str, float]:
    """The published peaks of ``card`` (``torch.cuda.get_device_name``);
    an unknown card raises: a share of a guessed peak means nothing."""
    try:
        return PEAKS[card]
    except KeyError:
        raise KeyError(f"no published peaks for {card!r}") from None


def bound_ms(flops: float, nbytes: float, dtype: str,
             card: str = "NVIDIA H100 80GB HBM3") -> float:
    """The least time in ms: the larger of the operations over the dtype's
    peak and the bytes over HBM bandwidth."""
    p = peaks(card)
    return 1e3 * max(flops / p[dtype], nbytes / p["hbm_bytes_per_s"])


def flash_launch(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                 causal: bool, dtype: str) -> Tuple[int, int]:
    """One flash forward call, (B, Hq, Sq, D) queries against (B, Hkv, Skv,
    D) keys and values: 4 D operations per (query, key) pair the top-left
    causal mask keeps (q kᵀ and p v); q, k, v read and o written once."""
    if causal:
        full = min(sq, skv)
        pairs = full * (full + 1) // 2 + (sq - full) * skv
    else:
        pairs = sq * skv
    flops = 4 * d * b * hq * pairs
    nbytes = DTYPE_BYTES[dtype] * d * (2 * b * hq * sq + 2 * b * hkv * skv)
    return flops, nbytes


def ssd_launch(b: int, s: int, h: int, p: int, n: int, chunk: int
               ) -> Tuple[int, int]:
    """One SSD intra-chunk call: C Bᵀ (2 N per kept pair) once per (batch,
    chunk), since B and C are one group; the decay-weighted product with X
    (2 P per kept pair) and the chunk state (2 Q N P) once per (batch,
    chunk, head).  x, dt, A_log, B, C read and y, the states and the chunk
    log-decays written once, in float32."""
    q = min(chunk, s)
    nc = -(-s // q)
    ctas = b * nc * h
    pairs = q * (q + 1) // 2
    flops = b * nc * pairs * 2 * n + ctas * (pairs * 2 * p + 2 * q * n * p)
    floats = (2 * b * nc * q * h * p          # x in, y out
              + b * nc * q * h + h            # dt, A_log
              + 2 * b * nc * q * n            # B, C
              + ctas * n * p + ctas)          # states, chunk log-decays
    return flops, 4 * floats


def swiglu_launch(e: int, m: int, k: int, f: int, dtype: str
                  ) -> Tuple[int, int]:
    """One fused SwiGLU call, h = silu(x Wg) * (x Wu) for E experts of (M,
    K) rows: the two products' 4 E M K F operations; x, Wg, Wu read and h
    written once."""
    flops = 4 * e * m * k * f
    nbytes = DTYPE_BYTES[dtype] * e * (m * k + 2 * k * f + m * f)
    return flops, nbytes
