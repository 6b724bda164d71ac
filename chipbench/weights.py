"""Weights drawn from the run's seed on the device, the same for the
program and for the reference.

The parameters, in the order of their names, are cut into chunks of about
``CHUNK`` elements; each chunk's normal draws come from one
``torch.Generator`` seeded from (seed, chunk) in one call, so a chunk can
be drawn again alone.  A leaf drawn ``("normal", std)`` takes its slice
of its chunk times ``std``; ``("ones",)``, ``("zeros",)`` and
``("log_linspace", a, b)`` (log of ``size`` evenly spaced values from a
to b) take no draws.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

CHUNK = 1 << 27

Layout = Sequence[Tuple[str, Tuple[int, ...], Tuple]]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _chunks(layout: Layout) -> List[List[Tuple[str, Tuple[int, ...], Tuple]]]:
    out, cur, size = [], [], 0
    for leaf in layout:
        cur.append(leaf)
        if leaf[2][0] == "normal":
            size += _numel(leaf[1])
        if size >= CHUNK:
            out.append(cur)
            cur, size = [], 0
    if cur:
        out.append(cur)
    return out


def _chunk_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index) % (1 << 63)


def draw(layout: Layout, seed: int, device
         ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, float32 tensor) for every leaf, chunk by chunk: each chunk's
    draws are one tensor, alive only while its leaves are handed out."""
    for index, chunk in enumerate(_chunks(layout)):
        total = sum(_numel(s) for _, s, init in chunk if init[0] == "normal")
        buf = None
        if total:
            gen = torch.Generator(device).manual_seed(
                _chunk_seed(seed, index))
            buf = torch.randn(total, generator=gen, device=device)
        off = 0
        for name, shape, init in chunk:
            kind = init[0]
            if kind == "normal":
                n = _numel(shape)
                yield name, (buf[off:off + n] * init[1]).view(shape)
                off += n
            elif kind == "ones":
                yield name, torch.ones(shape, device=device)
            elif kind == "zeros":
                yield name, torch.zeros(shape, device=device)
            elif kind == "log_linspace":
                yield name, torch.log(torch.linspace(
                    init[1], init[2], shape[0], device=device))
            else:
                raise ValueError(f"{name}: unknown draw {init!r}")
        del buf


def materialise(layout: Layout, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf as a new float32 tensor."""
    return {name: t.clone() for name, t in draw(layout, seed, device)}


def load_into(named: Dict[str, torch.Tensor], layout: Layout, seed: int,
              device) -> None:
    """Copy every leaf into the tensor of the same name in ``named``
    (shapes checked)."""
    check(named, layout)
    with torch.no_grad():
        for name, t in draw(layout, seed, device):
            named[name].copy_(t)


def check(named: Dict[str, torch.Tensor], layout: Layout) -> None:
    """``named`` holds exactly the leaves of ``layout``, at their shapes."""
    want = {name: tuple(shape) for name, shape, _ in layout}
    have = {name: tuple(t.shape) for name, t in named.items()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        wrong = sorted(n for n in set(want) & set(have)
                       if want[n] != have[n])
        raise ValueError(f"parameters differ from the reference's layout: "
                         f"missing {missing[:5]}, extra {extra[:5]}, "
                         f"shapes {wrong[:5]}")


def change_norms(named: Dict[str, torch.Tensor], layout: Layout, seed: int,
                 device) -> Dict[str, float]:
    """||p - p0|| of every leaf, p0 drawn again from the seed."""
    out = {}
    with torch.no_grad():
        for name, p0 in draw(layout, seed, device):
            out[name] = float(torch.linalg.vector_norm(named[name].float() - p0))
    return out
