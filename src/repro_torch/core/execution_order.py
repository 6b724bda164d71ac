"""Algorithm 1: Compute Execution Order (NNTrainer §4.1).

Training of an N-layer model is decomposed into 3N phases:

    EO_F(i)  = i                         (forward, front to back)
    EO_CG(i) = EO_max - (i + 1) * 2      (compute gradient, back to front)
    EO_CD(i) = EO_CG(i) + 1              (compute derivative / apply grad)

with ``EO_max = 3 * N``.  Every tensor requested by layer *i* receives the
subset of {EO_F, EO_CG, EO_CD} selected by its lifespan.  Tensors with
Max lifespan span [0, EO_max]; Iteration-lifespan tensors span from their
first write to EO_max (reset after the iteration).

After assignment, MV / RV / E create-modes are merged:

* ``MV`` (modify-view, e.g. in-place activations): merged into the target
  iff ``min(EOs of merged) >= max(EOs of target)`` — otherwise the target
  is read after the overwrite and integrity breaks (Fig. 5).
* ``RV`` (read-only view, e.g. flatten): always merged — data never
  changes, so integrity holds even with interval overlap (Fig. 6).
* ``E`` (extend, e.g. unrolled weights): always merged — spec and data are
  both shared (§5.2 time-unrolling).

Merging a tensor into a target also unions its EOs into the target so that
the Memory Planner sees the full live interval.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.graph import LayerGraph, tensor_requests
from repro_torch.core.lifespan import CreateMode, Lifespan, TensorSpec


@dataclasses.dataclass
class OrderedTensors:
    """Result of Algorithm 1: the Tensor-Pool map with EOs + merges applied."""

    # name -> spec (post-merge owners + placeholders)
    tensors: Dict[str, TensorSpec]
    merged: Dict[str, str]                  # merged tensor name -> owner name
    eo_max: int
    layer_orders: Dict[str, Tuple[int, int, int]]  # layer -> (F, CG, CD)

    def owner(self, name: str) -> str:
        """Resolve a tensor name to the name owning its storage."""
        while name in self.merged:
            name = self.merged[name]
        return name

    def planned_tensors(self) -> List[TensorSpec]:
        """Tensors that need arena storage (CREATE owners, not placeholders)."""
        return [
            t for t in self.tensors.values()
            if t.create_mode == CreateMode.CREATE and t.merged_into is None
        ]

    def phase_schedule(self) -> List[Tuple[int, str, str]]:
        """The full 3N-phase timeline: (eo, layer, kind) sorted by EO.

        ``kind`` is one of "F" / "CG" / "CD".  Forward phases occupy EOs
        0..N-1 and backward phases N..3N-1; EOs are unique across phases, so
        this is the walk order of the layer-basis executor — the timeline the
        proactive swap engine ticks along.
        """
        phases: List[Tuple[int, str, str]] = []
        for lname, (eo_f, eo_cg, eo_cd) in self.layer_orders.items():
            phases.append((eo_f, lname, "F"))
            phases.append((eo_cg, lname, "CG"))
            phases.append((eo_cd, lname, "CD"))
        return sorted(phases)


def _orders_for(lifespan: Lifespan, eo_f: int, eo_cg: int, eo_cd: int,
                eo_max: int) -> List[int]:
    if lifespan == Lifespan.MAX:
        return [0, eo_max]
    if lifespan == Lifespan.ITERATION:
        # live from first touch in this layer to the end of the iteration
        return [eo_f if lifespan.spans_forward else eo_cg, eo_max]
    orders: List[int] = []
    if lifespan.spans_forward:
        orders.append(eo_f)
    if lifespan.spans_calc_grad:
        orders.append(eo_cg)
    if lifespan.spans_calc_deriv:
        orders.append(eo_cd)
    return orders


def compute_execution_order(graph: LayerGraph, batch: int) -> OrderedTensors:
    """Run Algorithm 1 over a compiled graph."""
    layers = graph.layers
    n = len(layers)
    eo_max = 3 * n

    layer_orders: Dict[str, Tuple[int, int, int]] = {}
    for i, l in enumerate(layers):
        eo_f = i
        eo_cg = eo_max - (i + 1) * 2
        eo_cd = eo_cg + 1
        layer_orders[l.name] = (eo_f, eo_cg, eo_cd)

    # ---- lines 3..12: accumulate EOs into the tensor map --------------------
    tmap: Dict[str, TensorSpec] = {}
    for lname, spec in tensor_requests(graph, batch):
        eo_f, eo_cg, eo_cd = layer_orders[lname]
        node = graph.layer(lname)
        existing = tmap.get(spec.name)
        if existing is None:
            tmap[spec.name] = spec
            existing = spec
        if spec.name == f"X:{lname}":
            # Output activation produced by this layer: written at our F.
            # Everything later (consumer CG reads, loss reads, in-place CD
            # reads) is added by the consumer pass below — crucially, a saved
            # activation is freed after its *consumer's* compute-gradient,
            # not after the producer's (Fig. 4: X1 has orders 0 and 5, where
            # 5 is L1's CG, not L0's).
            orders = [eo_f]
            if node.kind == "activation":
                orders.append(eo_cd)  # derivative computed from own output
        else:
            orders = _orders_for(spec.lifespan, eo_f, eo_cg, eo_cd, eo_max)
            # Layers that skip compute-derivative (first layer / frozen
            # boundary) drop the CD order for their *input-side* tensors;
            # the CD phase itself is still scheduled (it applies gradients).
            if not node.needs_input_derivative and spec.name.startswith("D:"):
                orders = [o for o in orders if o != eo_cd] or orders
        existing.add_orders(orders)
        # Keep the "most conservative" lifespan when different layers request
        # the same tensor: union is realised by the EO set itself.
        if spec is not existing and spec.create_mode != existing.create_mode:
            # A consumer may request the producer's tensor with CREATE while
            # the producer declared a view; prefer the view declaration.
            if existing.create_mode == CreateMode.CREATE and spec.create_mode in (
                CreateMode.MODIFY_VIEW, CreateMode.READONLY_VIEW, CreateMode.EXTEND,
            ):
                existing.create_mode = spec.create_mode
                existing.view_of = spec.view_of

    # Consumers also touch their *input* activations: layer i reading
    # X:<producer> at its own F (and CG if weighted) — those EOs were encoded
    # in the producer-side lifespan via _consumer_save_lifespan, but the
    # actual order values must come from the consumer's schedule.  Add them.
    for i, l in enumerate(layers):
        eo_f, eo_cg, eo_cd = layer_orders[l.name]
        for inp in l.inputs:
            xname = f"X:{inp}"
            if xname not in tmap:
                continue
            t = tmap[xname]
            orders = [eo_f]
            from repro_torch.core.graph import WEIGHTED_KINDS, LOSS_KINDS
            if l.kind in WEIGHTED_KINDS and l.trainable:
                orders.append(eo_cg)
            # NOTE: an activation consumer does NOT read its input after
            # forward — its derivative comes from its *output* (in-place).
            # A pool2d consumer DOES: max-pool backward re-reads the argmax
            # source at its CD phase.  Record the access, otherwise the
            # offload planner sees a false idle window there and swaps would
            # race the read.
            if l.kind == "pool2d":
                orders.append(eo_cd)
            if l.kind in LOSS_KINDS:
                orders.extend([eo_cg, eo_cd])
            t.add_orders(orders)
            # The consumer's CD phase *writes* D:<inp>; the producer's CG/CD
            # phases read it.
            dname = f"D:{inp}"
            if dname in tmap and l.needs_input_derivative:
                tmap[dname].add_orders([eo_cd])

    # ---- lines 13..23: merge views ------------------------------------------
    merged: Dict[str, str] = {}
    order = sorted(tmap.values(), key=lambda t: t.min_eo)
    for t in order:
        if t.create_mode == CreateMode.MODIFY_VIEW and t.view_of:
            target = tmap.get(t.view_of)
            if target is None:
                t.create_mode = CreateMode.CREATE
                continue
            target_owner = tmap[_resolve(merged, t.view_of)]
            # MV may not overwrite externally-owned memory (the data set's
            # input buffer must survive the iteration).
            if target_owner.create_mode == CreateMode.PLACEHOLDER:
                t.create_mode = CreateMode.CREATE
                continue
            # line 17: min(EOs of merged) >= max(EOs of target)
            if t.min_eo >= target_owner.max_eo:
                _merge(tmap, merged, t, target_owner)
            # else: integrity not guaranteed — keep a fresh tensor (mode C)
            else:
                t.create_mode = CreateMode.CREATE
        elif t.create_mode in (CreateMode.READONLY_VIEW,
                               CreateMode.EXTEND) and t.view_of:
            target_owner = tmap.get(_resolve(merged, t.view_of))
            if target_owner is not None:
                _merge(tmap, merged, t, target_owner)
            else:
                t.create_mode = CreateMode.CREATE

    return OrderedTensors(tensors=tmap, merged=merged, eo_max=eo_max,
                          layer_orders=layer_orders)


def _resolve(merged: Dict[str, str], name: str) -> str:
    while name in merged:
        name = merged[name]
    return name


def _merge(tmap: Dict[str, TensorSpec], merged: Dict[str, str],
           t: TensorSpec, owner: TensorSpec) -> None:
    """Merge tensor ``t`` into ``owner``, unioning execution orders."""
    if owner.name == t.name:
        return
    merged[t.name] = owner.name
    t.merged_into = owner.name
    owner.add_orders(t.exec_orders)
    # A view can be *larger* in spec only for E (same spec); MV/RV share the
    # same data extent.  Keep the max byte size to stay safe.
    if t.nbytes > owner.nbytes:
        raise ValueError(
            f"view {t.name} ({t.nbytes}B) larger than target {owner.name} "
            f"({owner.nbytes}B) — merge would overflow the target's storage"
        )
