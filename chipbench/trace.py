"""Traced steps: ``torch.profiler`` reduced to the card's busy time, kernel
times by name and the top device operations (``card_time``), and the idle
gaps by what the host was doing (``idle_gaps``).

``card_time`` is ``chip_smoke.py``'s ``_device_idle_share`` (torch.profiler
around steady steps, busy time from the card's events over the host's wall
time), frozen here with three changes: busy time is the union of the
card's event intervals, so work on two streams at once counts once; copies
count as busy, since the card is not idle while it copies; and the host's
operations are not recorded, since recording them slows the host's side of
a step and opens gaps that an untraced step does not have.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOW_SPAN = "bench.window"
TOP = 10
GAPS_NAMED = 400


@contextlib.contextmanager
def profiled(cuda: bool, host: bool):
    """A profiler over the body: the card's activity where there is a
    card, the host's operations too when ``host``."""
    acts = ([ProfilerActivity.CUDA] if cuda else []) \
        + ([ProfilerActivity.CPU] if host or not cuda else [])
    with profile(activities=acts) as prof:
        yield prof


def _events(prof):
    """(start ns, end ns, name, on the card) of every event of a finished
    profile, read from the profiler's raw results (building its Python
    event tree takes minutes for a step's hundred thousand operations); a
    host span drawn on the card's line is left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        card = e.device_type() == DeviceType.CUDA
        if card and e.is_user_annotation():
            continue
        out.append((e.start_ns(), e.end_ns(), e.name(), card))
    return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def card_time(prof, window_s: float) -> Dict:
    """From a profile of the card's activity over a window of ``window_s``
    host seconds that began and ended with the card idle: ``window_s``,
    ``busy_s`` (the union of the card's event intervals), ``kernels``
    {name: device s} and ``device_ops`` (the top ones, [name, s])."""
    dev = [e for e in _events(prof) if e[3]]
    kernels: Dict[str, float] = {}
    for a, b, name, _ in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e9
    busy_ns = sum(b - a for a, b in _merge([e[:2] for e in dev]))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy_ns / 1e9,
            "kernels": kernels,
            "device_ops": [[k[:160], v] for k, v in top]}


KINDS = (("flash kernel", ("flash_fwd",)), ("swiglu kernel", ("swiglu",)),
         ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
         ("copy", ("Memcpy", "Memset", "copy_kernel", "direct_copy")),
         ("reduction", ("reduce_kernel", "Reduce")),
         ("elementwise", ("elementwise",)))


def by_kind(kernels: Dict[str, float]) -> Dict[str, float]:
    """Device seconds summed by kind of kernel (the first kind whose name
    part the kernel's name holds; "other" for none)."""
    out: Dict[str, float] = {}
    for name, s in kernels.items():
        kind = next((k for k, parts in KINDS
                     if any(p in name for p in parts)), "other")
        out[kind] = out.get(kind, 0.0) + s
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _deepest(cpu: List, starts: List[float], t: float) -> Optional[str]:
    """The name of the latest-starting host event that contains ``t`` (the
    innermost of nested ones), CUDA runtime calls passed over."""
    i = bisect.bisect_right(starts, t) - 1
    seen = 0
    while i >= 0 and seen < 50_000:
        _, end, name, _ = cpu[i]
        if end >= t and not name.startswith(("cuda", "cu")):
            return name
        i -= 1
        seen += 1
    return None


def idle_gaps(prof) -> List[List]:
    """From a profile of the host and the card over the ``bench.window``
    span: [what the host was doing, s], the card's idle time inside the
    span summed by the innermost host event at each gap's middle, for the
    longest ``GAPS_NAMED`` gaps; the top ``TOP``."""
    events = _events(prof)
    window = [e for e in events if e[2] == WINDOW_SPAN and not e[3]]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    t0, t1 = window[0][:2]
    dev = [(max(a, t0), min(b, t1)) for a, b, _, card in events if card]
    merged = _merge([(a, b) for a, b in dev if b > a])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    cpu = sorted(e for e in events if not e[3] and e[2] != WINDOW_SPAN)
    starts = [e[0] for e in cpu]
    named: Dict[str, float] = {}
    for a, b in gaps[:GAPS_NAMED]:
        who = _deepest(cpu, starts, (a + b) / 2) or "no host event"
        named[who] = named.get(who, 0.0) + (b - a) / 1e9
    return sorted(([k[:160], v] for k, v in named.items()),
                  key=lambda kv: -kv[1])[:TOP]
