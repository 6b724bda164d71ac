"""On-device personalization via transfer learning (paper §5.2, HandMoji),
on the PyTorch port.

A frozen ResNet18 backbone + trainable classifier head learns user-drawn
classes from a handful of examples.  It shows the paper's central claims
end to end on the layer-basis executor:

 * the slice realizer freezes the backbone, so dead-derivative pruning
   drops every backbone gradient and derivative tensor;
 * the memory planner's peak for transfer learning is a fraction of full
   training's (Fig. 12);
 * the head personalises in 60 epochs of 4 classes x 5 sketches.

The port of ``examples/personalize_transfer.py``: each epoch is one
``compile_plan(...).loss_and_grads`` replay and an in-place SGD step.  It
runs on the CUDA card; pass ``--device cpu`` for the plain PyTorch path:

    PYTHONPATH=src python examples/torch_personalize_transfer.py
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.exec.layers import reference_forward, sgd_update_
from repro_torch.core.plan import MemoryPlanConfig, compile_plan
from repro_torch.core.zoo import resnet18, resnet18_transfer
from repro_torch.device import resolve_device, synchronize


def main(device=None, epochs: int = 60, batch: int = 16, classes: int = 4,
         n_shots: int = 5) -> dict:
    """Fig. 12's planned peaks, then ``epochs`` of the head on
    ``classes`` x ``n_shots`` synthetic sketches; returns the losses."""
    dev = resolve_device(device)

    # ---- memory plan: full training vs transfer (Fig. 12) ----------------
    # swap=False isolates the arena-packing comparison (Fig. 12 has no host)
    no_swap = MemoryPlanConfig(swap=False)
    full = compile_plan(resnet18(classes), no_swap, batch=batch).plan
    xfer_cp = compile_plan(resnet18_transfer(classes), no_swap, batch=batch)
    xfer = xfer_cp.plan
    print(f"planned peak, full training:     "
          f"{full.total_bytes / 2**20:8.2f} MiB")
    print(f"planned peak, transfer learning: "
          f"{xfer.total_bytes / 2**20:8.2f} MiB "
          f"({1 - xfer.total_bytes / full.total_bytes:.0%} saved)")

    # ---- personalize: frozen backbone + head on synthetic sketches -------
    # each "emoji" class is a cluster of n_shots noisy sketches around a
    # class prototype (cluster separation survives the frozen backbone)
    g = xfer_cp.graph
    params = xfer_cp.init_params(torch.Generator(dev).manual_seed(0),
                                 device=dev)
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(classes, 3, 32, 32)).astype(np.float32) * 0.5
    x = np.concatenate([
        centers[c] + 0.05 * rng.normal(size=(n_shots, 3, 32, 32)
                                       ).astype(np.float32)
        for c in range(classes)])
    y = np.eye(classes, dtype=np.float32).repeat(n_shots, axis=0)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    t0 = time.perf_counter()
    losses = []
    for _ in range(epochs):
        loss, grads, _ = xfer_cp.loss_and_grads(params, x, y)
        sgd_update_(params, grads, lr=3e-4)
        losses.append(float(loss))
    synchronize(dev)
    t_train = time.perf_counter() - t0

    with torch.no_grad():
        logits = reference_forward(g, params, x)
    acc = float((logits.argmax(-1) == y.argmax(-1)).float().mean())
    print(f"personalised on {dev} in {t_train:.1f}s: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, accuracy {acc:.0%}")
    assert losses[-1] < losses[0]
    return {"losses": losses, "accuracy": acc, "train_s": t_train,
            "full_peak_bytes": full.total_bytes,
            "transfer_peak_bytes": xfer.total_bytes}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
