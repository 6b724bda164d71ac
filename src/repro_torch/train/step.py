"""Train, prefill and decode steps on one device.

Port of ``repro/train/step.py``: ``make_train_step``, ``make_prefill_step``
and ``make_decode_step``.  The reference assembles mesh shardings around
the same model calls; on one card the steps are the calls themselves (the
serve steps without autograd).  Mesh and sharding belong to the TPU-pod
layer (ROADMAP item 11), so a ``StepBundle`` has no shardings.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import CompiledMemoryPlan
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer


@dataclasses.dataclass
class StepBundle:
    """The step function of one (arch, shape) cell and, for a train step,
    the compiled memory plan whose checkpoint policy the model installs
    around each block (the model's own plan at the micro-batch's tokens,
    ``transformer.memory_plan``)."""
    fn: Callable
    memory_plan: Optional[CompiledMemoryPlan] = None


def make_train_step(model: Model, optimizer: Optimizer, shape: ShapeConfig,
                    *, microbatches: int = 1) -> StepBundle:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the model's trainable module and ``opt_state`` the
    optimizer state over ``dict(params.named_parameters())``; both are
    updated in place (the reference donates them) and returned.  The step
    is ``value_and_grad(model.loss_fn)``: with ``microbatches`` > 1 the
    batch is split along its first axis, the grads of the chunks summed
    and divided by ``microbatches``, and so is the loss.  Then the
    optimizer's in-place update (``Optimizer.update_``), and metrics
    ``{"loss", "grad_norm"}``, the latter the fp32 norm over all grads.
    The values stay on the device; reading one waits for the step.
    """
    micro_tokens = (shape.global_batch // max(microbatches, 1)) \
        * shape.seq_len

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        if microbatches > 1:
            chunks = [{k: v.chunk(microbatches)[i] for k, v in batch.items()}
                      for i in range(microbatches)]
        else:
            chunks = [batch]
        loss = 0.0
        for chunk in chunks:
            part = model.loss_fn(params, chunk)
            part.backward()
            loss = loss + part.detach()
        # a parameter the loss does not reach (in probe mode: the
        # bypassed kernels' weights) gets a zero gradient, as jax.grad
        # gives
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in named.items()}
        if microbatches > 1:
            for g in grads.values():
                g.div_(microbatches)
            loss = loss / microbatches
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads.values()))
        optimizer.update_(grads, opt_state, named)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return StepBundle(fn=train_step,
                      memory_plan=transformer.memory_plan(model.cfg,
                                                          micro_tokens))


def make_prefill_step(model: Model) -> Callable:
    """(params, batch) -> logits (B, S, padded_vocab): ``model.forward``
    without autograd.  ``batch`` holds ``tokens`` (B, S) and, for the
    multimodal families, ``enc_frames`` (audio) or ``image_embeds`` (vlm),
    (B, T, d)."""

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
