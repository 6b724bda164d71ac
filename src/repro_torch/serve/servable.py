"""Servable model: one shared base tree, many per-user fine-tune sessions.

Port of ``repro/serve/servable.py``.  The paper's personalization
examples all share one structure: a backbone pre-trained in the cloud
stays frozen on device, and the per-user state is the small trainable
slice (the transfer head, the adapter) plus its optimizer moments.
``ServablePersonalizer`` materialises exactly that split: ``base_params``
is initialised once and *never written* — every session's forward pass
reads it by reference — while each :class:`Session` owns a private copy
of only the trainable owners' entries, which its momentum-SGD step
updates in place.  Memory per extra tenant is therefore the trainable
slice + its momentum, not the model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import CompiledMemoryPlan
from repro_torch.core.exec.layers import init_params
from repro_torch.core.exec.store import SwapExecStats
from repro_torch.core.graph import WEIGHTED_KINDS, LayerGraph
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


def trainable_owners(graph: LayerGraph) -> Tuple[str, ...]:
    """Storage-owning layer names whose weights train (E-shared unrolled
    copies collapse onto the first copy, matching the executor's grads)."""
    owners = []
    for l in graph.layers:
        if l.shares_weights_with:
            continue
        if l.kind in WEIGHTED_KINDS and l.trainable and l.weight_shapes():
            owners.append(l.name)
    return tuple(owners)


@dataclasses.dataclass
class Session:
    """One user's live fine-tune state."""
    user: str
    arena_share_bytes: int
    params: Params                          # trainable owners only
    velocity: Optional[Params] = None       # momentum moments, lazy-init
    step: int = 0


class ServablePersonalizer:
    """Wrap a zoo graph for multi-tenant per-user fine-tuning.

    All sessions share ``base_params`` (frozen: nothing writes it) and the
    compiled plans (owned by the service's
    :class:`~repro_torch.serve.buckets.PlanCache`).  ``train_step`` runs
    one planned iteration on the merged tree and applies momentum SGD to
    the session's private slice only.  ``base_params`` is He-initialised
    once from a ``torch.Generator`` seeded with ``seed``, on ``device``
    (the CUDA card when None).
    """

    def __init__(self, graph: LayerGraph, *, lr: float = 0.05,
                 momentum: float = 0.9, seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.graph = graph
        self.lr = lr
        self.momentum = momentum
        self.device = resolve_device(device)
        self.base_params: Params = init_params(
            graph, torch.Generator().manual_seed(seed), device=self.device)
        self.trainable_owners: Tuple[str, ...] = trainable_owners(graph)
        self.sessions: Dict[str, Session] = {}

    def open_session(self, user: str, arena_share_bytes: int) -> Session:
        if user in self.sessions:
            raise ValueError(f"session {user!r} already open")
        personal = {o: {k: w.clone() for k, w in self.base_params[o].items()}
                    for o in self.trainable_owners}
        sess = Session(user, arena_share_bytes, personal)
        self.sessions[user] = sess
        return sess

    def close_session(self, user: str) -> bool:
        return self.sessions.pop(user, None) is not None

    def merged_params(self, sess: Session) -> Params:
        """Shared frozen tree overlaid with the session's trainable slice."""
        return {**self.base_params, **sess.params}

    def personal_bytes(self, sess: Session) -> int:
        total = 0
        for entry in sess.params.values():
            total += sum(w.numel() * w.element_size()
                         for w in entry.values())
        if sess.velocity is not None:
            total *= 2
        return total

    def train_step(self, sess: Session, cp: CompiledMemoryPlan,
                   x: torch.Tensor, y: torch.Tensor, *,
                   mask: Optional[torch.Tensor] = None,
                   engine=None,
                   ) -> Tuple[float, SwapExecStats]:
        """One planned fine-tune step: replay the plan on the merged tree,
        then momentum-SGD the session's private slice.  ``engine``
        optionally injects a transfer engine (e.g. bus-paced) into the
        replay."""
        loss, grads, stats = cp.loss_and_grads(
            self.merged_params(sess), x, y, mask=mask, engine=engine)
        self.apply_update(sess, grads)
        return float(loss), stats

    @torch.no_grad()
    def apply_update(self, sess: Session, grads: Params) -> None:
        """Momentum-SGD the session's private slice with ``grads``, in
        place.

        Split from :meth:`train_step` so the phase-interleaved scheduler
        (which drives the replay itself through a
        :class:`~repro_torch.core.exec.ScheduleCursor`) applies the
        identical update when a cursor finishes.
        """
        if sess.velocity is None:
            sess.velocity = {o: {k: torch.zeros_like(w)
                                 for k, w in entry.items()}
                             for o, entry in sess.params.items()}
        for owner, gentry in grads.items():
            if owner not in sess.params:
                continue
            ventry = sess.velocity[owner]
            pentry = sess.params[owner]
            for k, g in gentry.items():
                ventry[k].mul_(self.momentum).add_(g)
                pentry[k].sub_(self.lr * ventry[k])
        sess.step += 1
