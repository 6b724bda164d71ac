"""Every collective of the port, over a mesh axis's process group, with a
tally of what each moved.

The sharded steps move data only through this module: the raw
collectives (:func:`all_reduce`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`permute`), the autograd Functions built on
them (:func:`copy_to` and :func:`reduce_from`, the two ends of a
tensor-parallel region; :func:`gather`, an all-gather whose backward
reduce-scatters the gradient, for an FSDP shard or a weight whose
columns a rank reads beyond its own block; :func:`gather_whole`, an
all-gather whose backward hands each rank its block of the gradient,
for a weight every rank then uses whole in the same replicated compute;
:func:`sum_scatter`, the sum of partial products of which each rank keeps
its block, whose backward all-gathers the gradient; :func:`shared_sum`,
the sum of partial values every rank then uses, whose backward sums the
ranks' partial gradients as well) and :func:`fetch`, which brings a stored
parameter shard to the layout its compute reads.  Each call adds to the
tally the reference's HLO analysis reads off a compiled module
(``repro/launch/hlo_analysis.py``): per kind a count, the operand bytes
and the result bytes (``launch/comm_analysis.py`` reports them).

An axis of size 1 moves nothing: no call is made and nothing is counted.
Sums of bfloat16 tensors are reduced in float32 and rounded once.  A gloo
group (the CPU, or several ranks sharing one card) moves CUDA tensors
through host copies; NCCL takes them as they are.  A failed collective
raises.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.sharding import rules as R

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_tally: Dict[str, Dict[str, int]] = {}
_log: Optional[List[dict]] = None


def reset_tally() -> None:
    """Set every kind's count and bytes to 0."""
    _tally.clear()
    _tally.update({k: {"count": 0, "operand_bytes": 0, "result_bytes": 0}
                   for k in KINDS})


reset_tally()


def tally() -> Dict[str, Dict[str, int]]:
    """A copy of the tally: kind -> count, operand and result bytes."""
    return {k: dict(v) for k, v in _tally.items()}


@contextlib.contextmanager
def record_calls():
    """Collect one record per collective made in the ``with`` body: kind,
    axis, operand and result shapes and bytes."""
    global _log
    prev, _log = _log, []
    found = _log
    try:
        yield found
    finally:
        _log = prev


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, axis: str, src: torch.Tensor, out: torch.Tensor
            ) -> None:
    d = _tally[kind]
    d["count"] += 1
    d["operand_bytes"] += _nbytes(src)
    d["result_bytes"] += _nbytes(out)
    if _log is not None:
        _log.append({"kind": kind, "axis": axis,
                     "operand_shape": tuple(src.shape),
                     "result_shape": tuple(out.shape),
                     "operand_bytes": _nbytes(src),
                     "result_bytes": _nbytes(out)})


def _mesh(mesh):
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("a collective needs a mesh (sharding.use_mesh)")
    return mesh


def _wire(t: torch.Tensor, group) -> Tuple[torch.Tensor, bool]:
    """(the contiguous buffer a collective of ``group`` reads, whether it
    is a host copy of a CUDA tensor)."""
    import torch.distributed as dist
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    buf = t.detach()
    return (buf.cpu() if staged else buf.contiguous()), staged


def _sum_dtype(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def all_reduce(t: torch.Tensor, axis, *, op: str = "sum",
               mesh=None) -> torch.Tensor:
    """The sum (or ``op="max"``) of ``t`` over ``axis``, a new tensor in
    t's dtype.  ``axis`` may be a tuple of axes: one collective where its
    axes of more than one rank are one axis or span the mesh (recorded
    under that axis, or the tuple of them), else one over each."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    if isinstance(axis, tuple):
        axes = mesh.wide(axis)
        if len(axes) > 1 and axes != mesh.wide(mesh.axis_names):
            for a in axes:
                t = all_reduce(t, a, op=op, mesh=mesh)
            return t
        axis = axes if len(axes) > 1 else (axes[0] if axes else None)
    if axis is None or (isinstance(axis, str) and mesh.shape[axis] == 1):
        return t
    group = mesh.group(axis)
    src = _sum_dtype(t)
    buf, staged = _wire(src, group)
    if not staged:
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    _record("all-reduce", axis, buf, buf)
    return buf.to(t.device, t.dtype)


def all_gather(t: torch.Tensor, axis: str, dim: int = 0, *,
               mesh=None) -> torch.Tensor:
    """The blocks of ``t`` of every rank along ``axis``, concatenated on
    ``dim`` in the axis's order (contiguous)."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if n == 1:
        return t
    group = mesh.group(axis)
    buf, staged = _wire(t.movedim(dim, 0), group)
    buf = buf.contiguous()
    out = torch.empty((n * buf.shape[0],) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=group)
    _record("all-gather", axis, buf, out)
    return out.to(t.device).movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, axis: str, dim: int = 0, *,
                   mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``t`` over ``axis``
    (contiguous, t's dtype)."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    n = mesh.shape[axis]
    if n == 1:
        return t
    group = mesh.group(axis)
    buf, staged = _wire(_sum_dtype(t).movedim(dim, 0), group)
    buf = buf.contiguous()
    if buf.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"{n} ways over {axis!r}")
    out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    dist.reduce_scatter_tensor(out, buf, op=dist.ReduceOp.SUM, group=group)
    _record("reduce-scatter", axis, buf, out)
    return out.to(t.device, t.dtype).movedim(0, dim).contiguous()


def permute(t: Optional[torch.Tensor], axis: str,
            send_to: Optional[int], recv_from: Optional[int],
            like: torch.Tensor, *, mesh=None) -> Optional[torch.Tensor]:
    """Send ``t`` to the rank at index ``send_to`` along ``axis`` and
    receive a tensor shaped as ``like`` from index ``recv_from`` (either
    may be None): one step of the reference's ``ppermute``.  Returns what
    was received, or None."""
    import torch.distributed as dist
    mesh = _mesh(mesh)
    group = mesh.group(axis)
    ops = []
    sent = got = None
    staged = False
    if send_to is not None:
        sent, staged = _wire(t, group)
        ops.append(dist.P2POp(dist.isend, sent,
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        staged = like.is_cuda and dist.get_backend(group) == "gloo"
        got = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, recv_from), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    if sent is not None:
        _record("collective-permute", axis, sent, sent)
    return None if got is None else got.to(like.device)


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Enter a region split over ``axis``: the identity forward, the sum of
    the gradient over the axis backward."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, mesh=ctx.mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    """Leave a region split over ``axis``: the sum of the partial results
    forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather forward; reduce-scatter of the gradient backward (the
    FSDP pair: every rank's gradient of the gathered tensor summed, and
    each rank keeps its block)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return all_gather(x, axis, dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim, mesh=ctx.mesh), None, \
            None, None


class _GatherWhole(torch.autograd.Function):
    """All-gather forward; this rank's block of the gradient backward.
    Every rank runs the same replicated compute from the gathered tensor
    (the sLSTM recurrence), so each already holds the whole gradient of
    it: the block is a slice.  (``_Gather``'s reduce-scatter would sum
    the ranks' equal gradients, so multiply them by the ranks.)"""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        ctx.size = x.shape[dim]
        return all_gather(x, axis, dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = _mesh(ctx.mesh)
        start = mesh.coords()[ctx.axis] * ctx.size
        return g.narrow(ctx.dim, start, ctx.size).contiguous(), None, \
            None, None


class _SumScatter(torch.autograd.Function):
    """Reduce-scatter forward: each rank holds a partial product over the
    whole of ``dim`` and keeps its block of the sum; the all-gather of the
    gradient backward (every rank's partial product reaches every block)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.axis, ctx.dim, ctx.mesh = axis, dim, mesh
        return reduce_scatter(x, axis, dim, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim, mesh=ctx.mesh), None, \
            None, None


class _SharedSum(torch.autograd.Function):
    """All-reduce forward and backward: each rank holds a partial sum of a
    value that every rank then uses (a variance over columns split across
    the axis, a mean over rows split across it), and each rank's
    gradient of that shared value covers only its own use of it, so the
    gradients are summed too.  (``reduce_from``'s identity backward is
    right only where every rank receives the whole gradient.)"""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return all_reduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, mesh=ctx.mesh), None, None


def copy_to(x: torch.Tensor, axis: str = "model", *,
            mesh=None) -> torch.Tensor:
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _CopyTo.apply(x, axis, mesh)


def reduce_from(x: torch.Tensor, axis: str = "model", *,
                mesh=None) -> torch.Tensor:
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _ReduceFrom.apply(x, axis, mesh)


def gather(x: torch.Tensor, axis: str, dim: int, *,
           mesh=None) -> torch.Tensor:
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _Gather.apply(x, axis, dim, mesh)


def gather_whole(x: torch.Tensor, axis: str, dim: int, *,
                 mesh=None) -> torch.Tensor:
    """The whole of ``x`` along ``dim`` over ``axis``
    (:class:`_GatherWhole`); ``x`` itself without a mesh or on an axis of
    size 1."""
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _GatherWhole.apply(x, axis, dim, mesh)


def sum_scatter(x: torch.Tensor, axis: str, dim: int, *,
                mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    over ``axis`` (:class:`_SumScatter`); ``x`` itself without a mesh or
    on an axis of size 1."""
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _SumScatter.apply(x, axis, dim, mesh)


def shared_sum(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis`` (:class:`_SharedSum`);
    ``x`` itself without a mesh or on an axis of size 1."""
    mesh = R.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return x
    return _SharedSum.apply(x, axis, mesh)


def fetch(p: torch.Tensor, dim: Optional[int] = None, start: int = 0,
          length: Optional[int] = None) -> torch.Tensor:
    """The compute view of a stored parameter: its block of the dim
    ``dim`` (``start``, ``length``: global indices of a dim the storage
    does not shard) and, for every dim the storage shards over a batch
    axis (FSDP), the whole of it, gathered.  Dims sharded over ``model``
    stay local: that is the tensor-parallel layout the compute reads.
    The gather's backward reduce-scatters the gradient over an axis the
    active rules split the batch over; over one they do not (a batch
    that does not split: every rank along it runs the same compute and
    holds the whole gradient) it keeps the rank's block of it
    (:func:`gather_whole`), so the batch is counted once.  Without a
    mesh, or for a parameter the mesh does not shard, the parameter (or
    its block) itself."""
    whole = dim is None or (start == 0 and length in (None, p.shape[dim]))
    t = p if whole else p.narrow(dim, start, length)
    sh = getattr(p, "_sharding", None)
    if R.current_mesh() is None or sh is None:
        return t
    batch = R.current_rules().get("batch") or ()
    for d in range(t.dim()):
        for axis in reversed(sh.dim_axes(d)):
            if axis != "model":
                t = (gather if axis in batch else gather_whole)(t, axis, d)
    return t


def split_over(p, dim: int, axis: str = "model") -> bool:
    """Whether a mesh is active and ``p``'s placement (``p`` a stored
    parameter or a ``NamedSharding``) splits its dim ``dim`` over ``axis``
    (more than one way)."""
    mesh = R.current_mesh()
    sh = p if isinstance(p, R.NamedSharding) else getattr(p, "_sharding",
                                                         None)
    return mesh is not None and sh is not None \
        and axis in sh.dim_axes(dim) and mesh.shape[axis] > 1


def block_start(p: torch.Tensor, dim: int) -> int:
    """The global index of the first entry of this rank's block of ``p``
    along ``dim``."""
    return p._sharding.block(dim) * p.shape[dim]


def block_start_of(local: int, whole: int, axis: str = "model") -> int:
    """The global index of the first entry of this rank's block of a dim
    of ``whole`` entries of which it holds ``local`` (its block along
    ``axis`` when ``local`` < ``whole``, else 0)."""
    if local == whole:
        return 0
    return R.current_mesh().coords()[axis] * local


def gather_global(t: torch.Tensor, sharding: "R.NamedSharding"
                  ) -> torch.Tensor:
    """The global tensor of which ``t`` is this rank's block under
    ``sharding`` (no autograd)."""
    with torch.no_grad():
        for d in range(t.dim()):
            for axis in reversed(sharding.dim_axes(d)):
                t = all_gather(t, axis, d, mesh=sharding.mesh)
    return t
