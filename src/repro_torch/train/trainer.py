"""Training loop: step function + data pipeline + checkpoint + fault runtime.

Port of ``repro/train/trainer.py``, on one device or on a mesh:

    restore-or-init -> [train_step -> heartbeat -> watchdog -> ckpt]* -> final

On a mesh (``Trainer(..., mesh=...)``, every rank of the world running
the same trainer with ``TrainerConfig(host_id=rank, n_hosts=world)``, the
rank and the world also naming its heartbeats and its watchdog's host)
each rank holds its blocks of the parameters and the AdamW state
(``train/step.py``), draws the same global batch and takes its rows (over
(pod, data) on a multi-pod mesh), and saves and restores its own blocks
(``checkpoint/ckpt.py``: a block the pods replicate is written once, and
a run saved on one mesh resumes on another: a (2, 1, 2) run on (2, 2) or
on one device).

One difference: a checkpoint is labelled with the number of steps it has
completed.  The reference labels it with the index of the step that has
just run (step ``n`` holds the parameters after ``n + 1`` updates), so a
run restarted from it repeats index ``n`` with the next batch and makes
one update more than an uninterrupted run; here a restart from step ``n``
continues exactly where the uninterrupted run would.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import BatchQueue, DataState, \
    synthetic_lm_producer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.runtime.fault import Heartbeat, StepWatchdog
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    heartbeat_dir: Optional[str] = None
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0


class Trainer:
    """``run()`` trains ``model`` on ``device`` (the CUDA card unless told
    otherwise) for ``tcfg.steps`` steps of ``shape.global_batch``
    sequences of ``shape.seq_len`` tokens."""

    def __init__(self, model: Model, optimizer: Optimizer,
                 shape: ShapeConfig, tcfg: TrainerConfig, *,
                 producer=None, microbatches: int = 1,
                 device: DeviceLike = None, mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.shape = shape
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.bundle = make_train_step(model, optimizer, shape, mesh=mesh,
                                      microbatches=microbatches)
        self.step_fn = self.bundle.fn
        self.ckpt = CheckpointManager(
            tcfg.ckpt_dir, keep=tcfg.keep_ckpts, host_id=tcfg.host_id,
            n_hosts=tcfg.n_hosts) if tcfg.ckpt_dir else None
        self.hb = Heartbeat(tcfg.heartbeat_dir, tcfg.host_id) \
            if tcfg.heartbeat_dir else None
        self.watchdog = StepWatchdog()
        self.producer = producer or synthetic_lm_producer(
            model.cfg.vocab, shape.seq_len)
        self.history: list = []

    # ------------------------------------------------------------------ run
    def init_state(self):
        params = self.bundle.shard_params(self.model.init(
            self.tcfg.seed, device=self.device, trainable=True))
        return params, self.bundle.init_state(params)

    def run(self) -> Dict[str, Any]:
        tcfg = self.tcfg
        start_step = 0
        data_state = DataState()
        params, opt_state = self.init_state()
        named = dict(params.named_parameters())

        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            start_step = self.ckpt.latest_step()
            _, ds = self.ckpt.restore(start_step, (named, opt_state),
                                      shardings=self._shardings())
            if ds:
                data_state = DataState.from_dict(ds)
        self.restored_data_state = data_state if start_step else None

        # on a mesh every rank draws the global batch and takes its rows
        host_batch = self.shape.global_batch if self.mesh is not None \
            else self.shape.global_batch // tcfg.n_hosts
        queue = BatchQueue(self.producer, batch=host_batch,
                           state=data_state)
        try:
            loss = None
            for step in range(start_step, tcfg.steps):
                np_batch, data_state = queue.get()
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in np_batch.items()}
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self.watchdog.record(step, dt, slowest_host=tcfg.host_id)
                if self.hb:
                    self.hb.beat(step)
                if step % tcfg.log_every == 0:
                    gnorm = float(metrics["grad_norm"])
                    self.history.append({"step": step, "loss": loss,
                                         "time_s": dt, "grad_norm": gnorm})
                    print(f"step {step:6d} loss {loss:9.4f} "
                          f"gnorm {gnorm:9.3f} {dt * 1000:8.1f} ms",
                          flush=True)
                done = step + 1
                if self.ckpt and done < tcfg.steps \
                        and done % tcfg.ckpt_every == 0:
                    self.ckpt.save(done, (named, opt_state),
                                   data_state.as_dict(),
                                   shardings=self._shardings())
            if self.ckpt:
                self.ckpt.save(tcfg.steps, (named, opt_state),
                               data_state.as_dict(), blocking=True,
                               shardings=self._shardings())
            return {"params": params, "opt_state": opt_state,
                    "final_loss": loss, "history": self.history,
                    "memory_plan": self.bundle.memory_plan.report()}
        finally:
            queue.close()


    def _shardings(self):
        """The (parameters', optimizer state's) placements on the mesh, or
        None on one device."""
        return None if self.mesh is None else self.bundle.in_shardings[:2]


def quick_train(cfg: ModelConfig, *, steps: int = 20, seq_len: int = 32,
                global_batch: int = 8, ckpt_dir: Optional[str] = None,
                microbatches: int = 1, optimizer: str = "adamw",
                device: DeviceLike = None) -> Dict:
    """Single-device convenience wrapper used by examples and tests."""
    model = build_model(cfg)
    opt = make_optimizer(optimizer)
    shape = ShapeConfig("custom", seq_len, global_batch, "train")
    tcfg = TrainerConfig(steps=steps, ckpt_every=max(steps // 2, 1),
                         ckpt_dir=ckpt_dir, log_every=max(steps // 10, 1))
    trainer = Trainer(model, opt, shape, tcfg, microbatches=microbatches,
                      device=device)
    return trainer.run()
