"""End to end: pretrain a ~100M-parameter LM for a few hundred steps, on
the PyTorch port.

The port of ``examples/distributed_pretrain.py``: the same config system,
data pipeline with its batch queue, sharded train step (data x model
parallel on the world's mesh), AdamW, async checkpointing, heartbeats and
the straggler watchdog (``repro_torch.train.trainer.Trainer``), on
``make_test_mesh(model=1)`` over the world: every rank one data shard.
Under ``torchrun`` the world is torchrun's (NCCL, one card a rank; gloo
with ``--device cpu``); run alone it is a world of one.  It runs on the
CUDA card unless given ``--device cpu``.  On more cards, raise the shape.

    PYTHONPATH=src python examples/torch_distributed_pretrain.py \\
        [--steps 300] [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/torch_distributed_pretrain.py
"""

import argparse
import os
import tempfile
import uuid
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_100m_config() -> ModelConfig:
    # ~103M params: 12L, d=640, untied 16k vocab
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=5, d_ff=2560, vocab=16128,
        attention_impl="naive", remat=False, dtype="float32")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def _join_world(device: torch.device):
    """(rank, world, whether this call started the process group): the
    world torchrun describes, else a world of one (a rendezvous file in a
    fresh temporary directory); an initialised group is used as it is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world = 0, 1
        init = "file://" + str(Path(tempfile.mkdtemp(prefix="rdv_"))
                               / uuid.uuid4().hex)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(minutes=10))
    return rank, world, True


def main(argv=None) -> dict:
    """Train for ``--steps`` steps and check, as the reference does, that
    the loss fell; returns the trainer's output with the first logged loss
    (``first``) and the parameter count beside it."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    rank, world, started = _join_world(device)
    try:
        cfg = make_100m_config()
        model = build_model(cfg)
        n_params = cfg.param_count()
        if rank == 0:
            print(f"model: {cfg.name}, {n_params / 1e6:.1f}M params, "
                  f"{world} rank(s) on {device.type}")

        mesh = make_test_mesh(model=1, device=device.type)
        shape = ShapeConfig("pretrain", args.seq_len, args.batch, "train")
        ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro100m_")
        tcfg = TrainerConfig(steps=args.steps, log_every=10,
                             ckpt_every=100, ckpt_dir=ckpt_dir,
                             heartbeat_dir=ckpt_dir + "/hb", host_id=rank,
                             n_hosts=world)
        trainer = Trainer(model, make_optimizer("adamw", lr=1e-3), shape,
                          tcfg, device=device, mesh=mesh)
        out = trainer.run()
        first = out["history"][0]["loss"]
        if rank == 0:
            print(f"\nloss {first:.3f} -> {out['final_loss']:.3f} "
                  f"over {args.steps} steps; checkpoints in {ckpt_dir}")
        assert out["final_loss"] < first
        return {**out, "first": first, "n_params": n_params,
                "ckpt_dir": ckpt_dir}
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
