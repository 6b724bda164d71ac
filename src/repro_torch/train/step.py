"""Serve steps on one device.

Port of ``repro/train/step.py:make_prefill_step`` / ``make_decode_step``.
The reference assembles mesh shardings around the same model calls; on one
card the steps are the calls themselves, run without autograd.  Mesh and
sharding belong to the TPU-pod layer, which is ported last; the train
step comes with the training slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model) -> Callable:
    """(params, {"tokens": (B, S)}) -> logits (B, S, padded_vocab)."""

    @torch.no_grad()
    def prefill(params, batch):
        return model.forward(params, batch)

    return prefill


def make_decode_step(model: Model) -> Callable:
    """(params, cache, {"tokens": (B,), "cache_len": (B,)})
    -> (logits (B, padded_vocab), cache); the cache is updated in place."""

    @torch.no_grad()
    def decode(params, state, batch):
        return model.decode_fn(params, state, batch["tokens"],
                               batch["cache_len"])

    return decode
