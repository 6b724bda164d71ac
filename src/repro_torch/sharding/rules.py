"""Logical-axis sharding rules for the port.

Port of ``repro/sharding/rules.py``.  Models name the axes of their
tensors *logically*; the active rule set maps each name to mesh axes.
Physical mesh axes:

    pod    -- across pods: pure data parallelism
    data   -- data parallelism / FSDP / sequence parallelism
    model  -- tensor parallelism

Logical axes used across the codebase:

    batch       -- global batch            -> ("pod", "data")
    seq         -- sequence (activations)  -> None (or "data" for SP)
    heads       -- attention heads         -> "model"
    kv_heads    -- KV heads                -> "model" iff divisible else None
    embed       -- d_model                 -> None (activations) / FSDP
                   "data" (parameters)
    mlp         -- d_ff                    -> "model"
    vocab       -- vocabulary              -> "model"
    expert      -- MoE experts             -> "model"
    kv_seq      -- KV-cache sequence       -> None ("data" for long context)
    stage       -- pipeline stage

The reference's docstring also lists ``qkv -> "model"``, but its
:data:`DEFAULT_RULES` has no ``"qkv"`` key, so the attention weights
(logical ``("embed", "qkv")``) are replicated over ``model``; the table is
copied as it is.

A spec is a tuple with one entry per leading dim: None, one mesh axis, or
a tuple of mesh axes (the reference's ``PartitionSpec`` entries), trailing
Nones dropped.  :class:`NamedSharding` pairs it with a mesh and cuts a
tensor to a rank's block.

The mesh and rules are process-wide, not thread-local as the reference's:
the CUDA autograd engine runs a checkpoint region's replay on a thread of
its own, and the replay must see the mesh its forward saw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Rules = Dict[str, Optional[Tuple[str, ...]]]
Spec = Tuple[Any, ...]

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "batch_nopod": ("data",),
    "seq": None,
    "sp_seq": ("data",),          # sequence parallelism (long context)
    "heads": ("model",),
    "kv_heads": None,             # overridden per-config when divisible
    "embed": None,
    "fsdp_embed": ("data",),      # ZeRO-3/FSDP weight sharding over data
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "kv_seq": None,
    "state": None,
    "conv": None,
}

_state: Dict[str, Any] = {"mesh": None, "rules": dict(DEFAULT_RULES)}


def set_mesh_and_rules(mesh, rules: Optional[Rules] = None) -> None:
    _state["mesh"] = mesh
    _state["rules"] = dict(DEFAULT_RULES)
    if rules:
        _state["rules"].update(rules)


def current_mesh():
    return _state["mesh"]


def current_rules() -> Rules:
    return _state["rules"]


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Rules] = None):
    prev = dict(_state)
    set_mesh_and_rules(mesh, rules)
    try:
        yield
    finally:
        _state.update(prev)


def batch_parts() -> int:
    """How many ways the active rules split the batch (1 without a
    mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape.get(a, 1)
                     for a in current_rules().get("batch") or ())


def spec_from_logical(logical: Sequence[Optional[str]], rules: Rules,
                      mesh) -> Spec:
    """The spec of ``logical`` under ``rules`` on ``mesh``: each name's
    mesh axes that exist and are not used by an earlier dim, trailing
    Nones dropped (the reference's ``_spec_from_logical``)."""
    mesh_axes = set(mesh.axis_names) if mesh is not None else set()
    out = []
    used = set()
    for ax in logical:
        phys = rules.get(ax) if ax is not None else None
        if phys is None:
            out.append(None)
            continue
        phys = tuple(p for p in phys if p in mesh_axes and p not in used)
        used.update(phys)
        out.append(None if not phys else
                   (phys[0] if len(phys) == 1 else tuple(phys)))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_to_spec(logical_axes: Sequence[Optional[str]]) -> Spec:
    """The spec of ``logical_axes`` against the active mesh and rules,
    mesh axes the mesh lacks dropped."""
    return spec_from_logical(logical_axes, current_rules(), current_mesh())


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a global tensor each rank holds.
    A dim sharded over several axes is cut row-major over them (the first
    axis slowest), as the reference's ``PartitionSpec`` cuts it."""
    mesh: Any
    spec: Spec

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        return axes_of(self.spec[dim]) if dim < len(self.spec) else ()

    def parts(self, dim: int) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dim_axes(dim))

    def used_axes(self) -> Tuple[str, ...]:
        return tuple(a for e in self.spec for a in axes_of(e))

    def replication(self) -> int:
        """How many ranks hold each block."""
        used = set(self.used_axes())
        return math.prod(n for a, n in self.mesh.shape.items()
                         if a not in used)

    def first_replica(self, coords: Optional[Dict[str, int]] = None
                      ) -> bool:
        """Whether this rank (or ``coords``) is the first of the ranks
        that hold its block: index 0 on every axis the spec does not
        use."""
        coords = self.mesh.coords() if coords is None else coords
        used = set(self.used_axes())
        return all(coords[a] == 0 for a in self.mesh.axis_names
                   if a not in used)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for dim, n in enumerate(global_shape):
            p = self.parts(dim)
            if n % p:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does "
                                 f"not split {p} ways ({self.spec})")
            out.append(n // p)
        return tuple(out)

    def block(self, dim: int, coords: Optional[Dict[str, int]] = None
              ) -> int:
        """This rank's (or ``coords``') block index along ``dim``."""
        coords = self.mesh.coords() if coords is None else coords
        idx = 0
        for a in self.dim_axes(dim):
            idx = idx * self.mesh.shape[a] + coords[a]
        return idx

    def index(self, global_shape: Sequence[int],
              coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
        coords = self.mesh.coords() if coords is None else coords
        local = self.shard_shape(global_shape)
        return tuple(slice(self.block(d, coords) * n,
                           (self.block(d, coords) + 1) * n)
                     for d, n in enumerate(local))

    def shard(self, t: torch.Tensor,
              coords: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """This rank's block of the global ``t`` (a view)."""
        return t[self.index(t.shape, coords)]


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Bring a replicated ``x`` to the layout ``logical_axes`` name under
    the active mesh and rules: this rank's block of it, a slice per
    sharded dim (the replicated-to-sharded move needs no communication).
    The identity without a mesh, or when the names do not cover x's dims,
    as the reference's."""
    mesh = current_mesh()
    if mesh is None or len(logical_axes) != x.dim():
        return x
    return NamedSharding(mesh, logical_to_spec(logical_axes)).shard(x)
