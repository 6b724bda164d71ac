"""Tacotron2-style decoder personalization (paper §5.2, Fig. 14), on the
PyTorch port.

The recurrent decoder (prenet -> 2 LSTM -> mel projection) is
time-unrolled by the Recurrent realizer; the unrolled copies share weights
via Tensor-sharing mode E and accumulate gradients across time (Iteration
lifespan), and the optimizer applies them once per iteration, as the
paper describes for Tacotron2 on NNTrainer.

The port of ``examples/tts_unroll.py``: each iteration is one
``compile_plan(...).loss_and_grads`` replay, the gradient clipped to norm
5, and an in-place SGD step.  It runs on the CUDA card; pass ``--device
cpu`` for the plain PyTorch path:

    PYTHONPATH=src python examples/torch_tts_unroll.py
"""

import argparse

import numpy as np
import torch

from repro_torch.core.exec.layers import sgd_update_
from repro_torch.core.plan import MemoryPlanConfig, compile_plan
from repro_torch.core.zoo import tacotron2_decoder
from repro_torch.device import resolve_device


def main(device=None, iterations: int = 300, steps: int = 4) -> dict:
    """``iterations`` of clipped SGD on the ``steps``-unrolled decoder;
    returns the losses."""
    dev = resolve_device(device)
    cp = compile_plan(
        tacotron2_decoder(time_steps=steps, mel_dim=16, prenet_dim=48,
                          lstm_dim=48),
        MemoryPlanConfig(swap=False), batch=16)

    # E-mode weight sharing: unrolled LSTM copies own NO extra weight memory
    shared = [n for n, t in cp.ordered.tensors.items()
              if n.startswith("W:") and t.merged_into]
    owned = [n for n, t in cp.ordered.tensors.items()
             if n.startswith("W:") and not t.merged_into]
    print(f"{steps}x unrolled: {len(owned)} owned weight tensors, "
          f"{len(shared)} E-shared views (zero extra bytes)")
    print(f"planned peak: {cp.plan.total_bytes / 2**20:.2f} MiB")

    # teacher-forced mel regression on a synthetic voice-like target
    params = cp.init_params(torch.Generator(dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    mel_in = torch.from_numpy(
        rng.normal(size=(16, 16)).astype(np.float32)).to(dev)
    target = torch.tanh(mel_in * 0.7 + 0.2)          # fixed mapping to learn

    losses = []
    for _ in range(iterations):
        loss, grads, _ = cp.loss_and_grads(params, mel_in, target)
        # gradient clipping (paper: supported for the unrolled decoder)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                               for entry in grads.values()
                               for g in entry.values()))
        scale = torch.clamp(5.0 / (gnorm + 1e-9), max=1.0)
        for entry in grads.values():
            for g in entry.values():
                g.mul_(scale)
        sgd_update_(params, grads, lr=0.5)
        losses.append(float(loss))
    print(f"teacher-forced training on {dev}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # the tied-weight unrolled stack is a hard function class; the
    # demo's point is the E-sharing mechanics (grads validated in tests)
    assert losses[-1] < losses[0] * 0.9
    return {"losses": losses, "owned": len(owned), "shared": len(shared)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
