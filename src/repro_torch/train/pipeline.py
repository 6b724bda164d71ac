"""GPipe-style pipeline parallelism over a mesh axis.

Port of ``repro/train/pipeline.py``.  Layers are split into S contiguous
stages along the ``stage`` mesh axis, one per rank of it.  The global
batch is split into M micro-batches; a fill-drain schedule runs
T = M + S - 1 ticks.  At every tick each stage runs its layers on its
input (stage 0 takes micro-batch t, clipped, the others what the stage
before sent) and passes the result on: one send/receive between
neighbours per tick (``collectives.permute``, the reference's
``ppermute``), inside an autograd Function whose backward sends the
gradient back the same way, so ``backward()`` of a pipelined loss runs
the GPipe backward schedule.  The last stage banks micro-batch
t - (S - 1); after the last tick its outputs go to every stage by a sum
of the stages' masked outputs (the reference's masked ``psum``), whose
backward hands each stage its own cotangent.

Every stage runs every tick (idle ticks on values that are never banked),
and every received activation is tied into the outputs with weight 0, so
each rank's backward runs every tick's send/receive in the same order as
its neighbours' and no pair of ranks waits on the other.

Bubble fraction = (S - 1) / (M + S - 1).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding import collectives as C


class _Shift(torch.autograd.Function):
    """Send ``y`` to the next stage and return what the previous stage
    sent (zeros on stage 0); backward: send the received value's gradient
    back and return the one the next stage sent for ``y`` (zeros on the
    last stage)."""

    @staticmethod
    def forward(ctx, y, axis, mesh):
        n, idx = mesh.shape[axis], mesh.coords()[axis]
        ctx.axis, ctx.mesh, ctx.n, ctx.idx = axis, mesh, n, idx
        got = C.permute(y, axis, idx + 1 if idx + 1 < n else None,
                        idx - 1 if idx > 0 else None, y, mesh=mesh)
        return torch.zeros_like(y) if got is None else got

    @staticmethod
    def backward(ctx, g):
        n, idx = ctx.n, ctx.idx
        got = C.permute(g.contiguous(), ctx.axis,
                        idx - 1 if idx > 0 else None,
                        idx + 1 if idx + 1 < n else None, g,
                        mesh=ctx.mesh)
        return (torch.zeros_like(g) if got is None else got), None, None


def pipeline_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor, *,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run micro-batches through the pipeline.

    stage_fn: (params_for_stage, activation) -> activation, same shape
    stage_params: this rank's stage's parameters (the reference's leading
        stage dim, sharded over ``axis``, taken)
    x_mb: (M, mb_size, ...) micro-batched input, the same on every rank
    returns: (M, mb_size, ...) outputs, the same on every rank (the last
    stage's)."""
    n_stages = mesh.shape[axis]
    idx = mesh.coords()[axis]
    n_mb = x_mb.shape[0]
    ticks = n_mb + n_stages - 1
    first = torch.tensor(idx == 0, device=x_mb.device)
    incoming = torch.zeros_like(x_mb[0])
    banked = [torch.zeros_like(x_mb[0]) for _ in range(n_mb)]
    tie = torch.zeros((), dtype=x_mb.dtype, device=x_mb.device)
    for t in range(ticks):
        x_in = torch.where(first, x_mb[min(t, n_mb - 1)], incoming)
        y = stage_fn(stage_params, x_in)
        if idx == n_stages - 1 and t >= n_stages - 1:
            banked[t - (n_stages - 1)] = y
        if t < ticks - 1:
            incoming = _Shift.apply(y, axis, mesh)
            tie = tie + 0.0 * incoming.sum()
    outputs = torch.stack(banked) + tie
    if idx != n_stages - 1:
        outputs = outputs * 0.0
    return C.reduce_from(outputs, axis, mesh=mesh)


def pipeline_loss(stage_fn: Callable, loss_fn: Callable, stage_params,
                  x_mb: torch.Tensor, y_mb: torch.Tensor, *, mesh,
                  axis: str = "stage") -> torch.Tensor:
    """Mean loss over micro-batches through the pipeline
    (differentiable)."""
    outs = pipeline_apply(stage_fn, stage_params, x_mb, mesh=mesh, axis=axis)
    return torch.stack([loss_fn(o, y) for o, y in zip(outs, y_mb)]).mean()


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def split_microbatches(x: torch.Tensor, n_mb: int) -> torch.Tensor:
    if x.shape[0] % n_mb:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_mb} "
                         "micro-batches")
    return x.reshape((n_mb, x.shape[0] // n_mb) + tuple(x.shape[1:]))
