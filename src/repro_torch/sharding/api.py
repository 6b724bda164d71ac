"""Sharding assembly: per-(arch, shape) rule sets and the placements of
parameter and state trees.

Port of ``repro/sharding/api.py``.  Two rule sets exist per run:

* activation rules -- installed process-wide (``use_mesh``) and read by
  the model's sharded compute: heads and kv heads go over ``model`` only
  when divisible; the batch over (pod, data) only when divisible (a
  batch of 1 falls back to sequence parallelism);

* parameter rules -- used only for the placements of the parameters and
  the optimizer state.  ``embed`` maps to the FSDP axis (``data``) for an
  architecture whose fp32 parameters exceed :data:`FSDP_PARAM_THRESHOLD`
  bytes (ZeRO-3-style weight sharding); the optimizer moments are always
  sharded so (ZeRO-1).

A tree here is a nested dict (or list) whose leaves are tuples: logical
axis names in a spec tree, a tensor's shape in a shape tree.  A placement
is a :class:`~repro_torch.sharding.rules.NamedSharding`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import NamedSharding, spec_from_logical

# parameter bytes above which FSDP weight sharding is enabled
FSDP_PARAM_THRESHOLD = 8e9

# override hooks: "rules" updates the activation rule set; "fsdp" forces
# ZeRO-3 on or off
_OVERRIDES: Dict[str, object] = {"rules": None, "fsdp": None}


def set_overrides(rules=None, fsdp=None) -> None:
    _OVERRIDES["rules"] = rules
    _OVERRIDES["fsdp"] = fsdp


def clear_overrides() -> None:
    set_overrides(None, None)


def _divisible(n: int, mesh, axes: Tuple[str, ...]) -> bool:
    size = 1
    for a in axes:
        if a in mesh.shape:
            size *= mesh.shape[a]
    return size > 0 and n % size == 0


def activation_rules(cfg: ModelConfig, shape: ShapeConfig,
                     mesh) -> R.Rules:
    rules: R.Rules = dict(R.DEFAULT_RULES)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if _divisible(shape.global_batch, mesh, batch_axes):
        rules["batch"] = batch_axes
        rules["kv_seq"] = None
    else:
        # long-context decode (batch 1): shard the KV / state sequence
        rules["batch"] = None
        rules["kv_seq"] = ("data",)
        rules["sp_seq"] = ("data",)
    rules["heads"] = ("model",) if _divisible(cfg.n_heads, mesh, ("model",)) \
        else None
    rules["kv_heads"] = ("model",) \
        if _divisible(cfg.n_kv_heads, mesh, ("model",)) else None
    if shape.kind == "decode" and rules["kv_heads"] is None:
        # kv heads that do not divide the model axis: the KV-cache
        # sequence goes over 'model' instead
        rules["kv_seq"] = tuple(rules["kv_seq"] or ()) + ("model",)
    if cfg.family in ("ssm", "hybrid"):
        state = cfg.ssm_state or 64
        rules["state"] = ("model",) if _divisible(state, mesh, ("model",)) \
            else None
    if _OVERRIDES["rules"]:
        rules.update(_OVERRIDES["rules"])
    return rules


def fsdp_on(cfg: ModelConfig, fsdp: Optional[bool] = None) -> bool:
    """Whether the parameters are FSDP-sharded: the override, else
    ``fsdp``, else the size rule."""
    if _OVERRIDES["fsdp"] is not None:
        return bool(_OVERRIDES["fsdp"])
    if fsdp is None:
        return cfg.param_count() * 4 > FSDP_PARAM_THRESHOLD
    return fsdp


def param_rules(cfg: ModelConfig, mesh, *, fsdp: Optional[bool] = None,
                zero1: bool = False) -> R.Rules:
    rules = dict(R.DEFAULT_RULES)
    rules["embed"] = ("data",) if fsdp_on(cfg, fsdp) or zero1 else None
    return rules


def _is_leaf(v) -> bool:
    return isinstance(v, tuple)


def tree_map_specs(fn, spec_tree, *rest):
    """``fn`` over the leaves (tuples) of ``spec_tree`` and the entries at
    the same places of ``rest``."""
    if _is_leaf(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: tree_map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    return type(spec_tree)(tree_map_specs(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(spec_tree))


class SplitSpecs(dict):
    """A module's spec dict (its leaves' logical axes) that also names the
    replicated leaves of which each ``model`` rank computes only a part
    under the active mesh and rules (its own heads or experts through a
    weight every rank holds whole), so that their gradients are summed
    over ``model``: ``partial(cfg, {leaf: NamedSharding}) -> leaf names``.
    The module that splits the compute declares it here, beside the rule
    its forward follows."""

    def __init__(self, specs, partial):
        super().__init__(specs)
        self.partial = partial


def partial_over_model(cfg: ModelConfig, spec_tree,
                       shardings: Dict[str, NamedSharding]) -> frozenset:
    """The dotted names (as ``shardings``, the flat placements, keys them)
    of every leaf a :class:`SplitSpecs` of ``spec_tree`` names, its rule
    read under the active mesh and rules."""
    out = set()

    def walk(tree, prefix):
        if _is_leaf(tree):
            return
        keys = list(tree) if isinstance(tree, dict) else range(len(tree))
        at = {k: f"{prefix}.{k}" if prefix else str(k) for k in keys}
        if isinstance(tree, SplitSpecs):
            leaves = {k: shardings[at[k]] for k in keys if _is_leaf(tree[k])}
            out.update(at[k] for k in tree.partial(cfg, leaves))
        for k in keys:
            walk(tree[k], at[k])

    walk(spec_tree, "")
    return frozenset(out)


def fit_spec(spec: R.Spec, shape, mesh) -> R.Spec:
    """``spec`` with every entry whose mesh axes do not divide its dim
    dropped to None (the safety net for odd dims)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, part in zip(shape, parts):
        if part is None:
            fixed.append(None)
            continue
        size = 1
        for a in R.axes_of(part):
            size *= mesh.shape[a]
        fixed.append(part if dim % size == 0 else None)
    while fixed and fixed[-1] is None:
        fixed.pop()
    return tuple(fixed)


def tree_shardings(mesh, spec_tree, rules: R.Rules, shape_tree=None):
    """A logical-axis tree mapped to placements; with ``shape_tree``, any
    axis whose dim its mesh axes do not divide is dropped to None."""
    def one(logical, shape=None):
        spec = spec_from_logical(logical, rules, mesh)
        if shape is not None:
            spec = fit_spec(spec, tuple(shape), mesh)
        return NamedSharding(mesh, spec)

    if shape_tree is None:
        return tree_map_specs(one, spec_tree)
    return tree_map_specs(one, spec_tree, shape_tree)


def param_shardings(mesh, cfg: ModelConfig, spec_tree, shape_tree=None, *,
                    fsdp: Optional[bool] = None, zero1: bool = False):
    return tree_shardings(mesh, spec_tree,
                          param_rules(cfg, mesh, fsdp=fsdp, zero1=zero1),
                          shape_tree)


def shard_module(module: torch.nn.Module,
                 shardings: Dict[str, NamedSharding]) -> torch.nn.Module:
    """Keep only this rank's block of every parameter of ``module`` (in
    place; each parameter remembers its placement as ``_sharding``, which
    :func:`~repro_torch.sharding.collectives.fetch` reads)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            sh = shardings[name]
            p.data = sh.shard(p.data).contiguous().clone()
            p._sharding = sh
    return module


def mark_sharded(module: torch.nn.Module,
                 shardings: Dict[str, NamedSharding]) -> torch.nn.Module:
    """Record each parameter's placement on a module that already holds
    its blocks."""
    for name, p in module.named_parameters():
        p._sharding = shardings[name]
    return module
