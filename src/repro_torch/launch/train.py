"""Training launcher, on one CUDA card or on a mesh of them.

    python -m repro_torch.launch.train --arch llama3.2-3b --shape train_4k \
        --steps 3 --batch 2 --microbatches 2 [--ckpt-dir D] \
        [--heartbeat-dir H] [--device cpu] [--test-mesh] [--dry-run] \
        [--stub-frontend]
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch llama3.2-3b --distributed --test-mesh [--multi-pod]

Port of ``repro/launch/train.py``: ``Trainer`` -> ``make_train_step`` ->
``model.loss_fn`` with AdamW (the reference's defaults, fp32 state, or
int8-block moments with ``--optimizer adamw_int8``) on
``synthetic_lm_producer``, each block checkpointed as the reference's
``jax.checkpoint`` calls do (a transformer block under the memory plan's
policy; a mamba, mLSTM or sLSTM block with nothing saved).  Every ported
LM family trains here: ``--arch llama3.2-3b``, ``granite-moe-1b-a400m``,
``zamba2-7b`` (its SSD scans through the SSD kernel, its shared block
through flash and SwiGLU) or ``xlstm-1.3b`` (its mLSTM scans through the
mLSTM kernel).  The multimodal families (``whisper-tiny``,
``llama-3.2-vision-11b``) train too, but their batches carry the stubbed
frontends' ``enc_frames`` or ``image_embeds``, which
``synthetic_lm_producer`` does not make (nor does the reference ship a
producer that does): this launcher refuses them unless given
``--stub-frontend``, which adds standard normals drawn from each
example's own seed; a caller with real embeddings trains them through
``Trainer(..., producer=...)``.  Weights are random from seed
0.  It runs on the card; ``--device cpu`` runs the plain PyTorch path on
the host.  Attention goes through the flash kernel
(``attention_impl="pallas"``; the config's own default is the blockwise
formulation).

``--test-mesh`` keeps its reference meaning: the reduced config at
sequence 64, batch 8.  ``--dry-run`` runs the cell's cost probe instead of
training (``launch/dryrun.py``: one micro-batch of ``--batch`` /
``--microbatches`` sequences, or by default of one sequence, the record
written under ``--dryrun-dir``) and returns its record.

``--distributed`` joins the world ``torchrun`` describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; ``--dist-init`` names another rendezvous,
a ``file://`` path for instance) and trains on ``make_test_mesh(model=2)``
over it, the counterpart of the reference's mesh over however many
devices there are: NCCL with one card per ``LOCAL_RANK``, gloo only with
``--device cpu``.  Every family trains there (``train/step.py``; the
multimodal families with ``--stub-frontend``, as on one card), a batch
that does not split over the mesh (``--batch 1``: every rank takes every
row) and int8 moments (``--optimizer adamw_int8``) included; with
``--dry-run`` it writes the mesh cell's record of one sharded step, its
counted FLOPs and bytes, its collectives and its roofline row
(``dryrun.run_mesh_cell``).

``--multi-pod`` (with ``--distributed``) trains on the reference's
multi-pod mesh at the world's size instead, ``make_pod_mesh``: (pod,
data, model) = (2, world / 4, 2), or (2, 1, 1) on a world of two: the
batch over (pod, data),
the parameters replicated over ``pod`` (the reference's step makes no
other use of the axis).  With ``--dry-run`` it writes the pod mesh's
record, ``<arch>__<shape>__<pod>x<data>x<model>.json`` marked ``"mesh":
"multipod"``.  Without ``--distributed`` it raises: a pod mesh needs a
world of ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Sequence


# the AdamW moments' dtype of each --optimizer
STATE_DTYPE = {"adamw": "float32", "adamw_int8": "int8"}

# the batch key each multimodal family needs beside tokens and targets
_FRONTEND_INPUTS = {"audio": "enc_frames (B, encoder_seq, d_model)",
                    "vlm": "image_embeds (B, image_tokens, d_model)"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: the shape's; train_4k's "
                         "256 sequences of 4096 tokens do not fit one card "
                         "with an fp32 AdamW state: use 2)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=sorted(STATE_DTYPE),
                    help="AdamW's moments: fp32 (adamw) or int8 blocks "
                         "(a --dry-run cell takes the reference's choice "
                         "for its arch)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--heartbeat-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--test-mesh", action="store_true",
                    help="reduced config at sequence 64, batch 8")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --distributed: train on the (pod, data, "
                         "model) mesh, (2, world / (2 model), model)")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the cell's cost probe instead of training")
    ap.add_argument("--dryrun-dir", default=None,
                    help="where --dry-run writes its record (default: "
                         "build/torch_dryrun)")
    ap.add_argument("--distributed", action="store_true",
                    help="train on a (data, model) mesh over torchrun's "
                         "world")
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's init_method (default: "
                         "torchrun's environment)")
    ap.add_argument("--stub-frontend", action="store_true",
                    help="a multimodal family's batches also carry the "
                         "stubbed frontend's embeddings: standard normals "
                         "from each example's seed")
    return ap


def _stub_frontend_producer(cfg, seq_len: int):
    """``synthetic_lm_producer``'s examples, each with the stubbed
    frontend's (T, d) embeddings under the family's key: standard normals
    drawn from the example's own (epoch, index) seed, so that a restarted
    run and every rank of a mesh draw the same."""
    import numpy as np

    from repro_torch.data.pipeline import synthetic_lm_producer
    tokens = synthetic_lm_producer(cfg.vocab, seq_len)
    key, t = (("image_embeds", cfg.image_tokens) if cfg.family == "vlm"
              else ("enc_frames", cfg.encoder_seq))

    def produce(epoch, index, rng):
        ex = tokens(epoch, index, rng)
        g = np.random.default_rng((epoch * 7919 + index) & 0x7FFFFFFF)
        ex[key] = g.standard_normal((t, cfg.d_model)).astype(np.float32)
        return ex

    return produce


def _join_world(args):
    """Initialise the process group torchrun describes and return (rank,
    world, device): NCCL on the card of LOCAL_RANK, gloo with --device
    cpu."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    local = int(os.environ.get("LOCAL_RANK", rank))
    if args.device is not None and torch.device(args.device).type == "cpu":
        backend, device = "gloo", torch.device("cpu")
    else:
        resolve_device(args.device)          # raises without a card
        torch.cuda.set_device(local)
        backend, device = "nccl", torch.device("cuda", local)
    dist.init_process_group(backend, init_method=args.dist_init, rank=rank,
                            world_size=world, timeout=timedelta(minutes=10))
    return rank, world, device


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    if args.multi_pod and not args.distributed:
        raise ValueError(
            "--multi-pod trains on a (pod, data, model) mesh, which needs a "
            "world of ranks: pass --distributed (under torchrun)")
    if args.distributed:
        import torch.distributed as dist
        rank, world, device = _join_world(args)
        try:
            return _run(args, rank=rank, world=world, device=device)
        finally:
            dist.destroy_process_group()
    return _run(args)


def _run(args, *, rank: int = 0, world: int = 1, device=None) -> Dict:
    mesh = None
    if args.multi_pod:
        from repro_torch.launch.mesh import make_pod_mesh
        mesh = make_pod_mesh(model=min(2, max(world // 2, 1)),
                             device=device.type)
    elif args.distributed:
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(model=min(2, world), device=device.type)
    device = device if device is not None else args.device

    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.models.model import build_model, reduce_config
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = ARCHS[args.arch]
    shape = SHAPES[args.shape]
    if shape.kind != "train":
        raise SystemExit("use repro_torch.launch.serve for serving shapes")
    if args.test_mesh:
        cfg = reduce_config(cfg)
        shape = dataclasses.replace(shape, seq_len=64, global_batch=8)
    else:
        cfg = dataclasses.replace(cfg, attention_impl="pallas")
    if args.batch is not None:
        shape = dataclasses.replace(shape, global_batch=args.batch)
    if shape.global_batch % args.microbatches:
        raise SystemExit(f"batch {shape.global_batch} does not split into "
                         f"{args.microbatches} micro-batches")
    if args.dry_run and mesh is not None:
        from repro_torch.launch import dryrun
        rec = dryrun.run_mesh_cell(
            args.arch, args.shape, mesh, args.dryrun_dir or dryrun.RESULTS,
            cfg=cfg, shape=shape, microbatches=args.microbatches,
            device=device)
        if rank == 0:
            print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh",
                                                  "collectives",
                                                  "roofline")}))
        return rec
    if args.dry_run:
        from repro_torch.launch import dryrun
        # without --batch or --microbatches, the dry run's own cut (one
        # sequence a micro-batch for train): a probe of train_4k's whole
        # 256 x 4096 batch at once does not fit the card
        split = args.batch is not None or args.microbatches > 1
        rec = dryrun.run_cell(
            args.arch, args.shape, args.dryrun_dir or dryrun.RESULTS,
            force=True, device=device, cfg=cfg, shape=shape,
            microbatch=shape.global_batch // args.microbatches if split
            else None)
        print(dryrun.summary_line(rec))
        return rec

    producer = None
    if cfg.family in _FRONTEND_INPUTS:
        if not args.stub_frontend:
            raise SystemExit(
                f"{args.arch} trains on batches that also hold "
                f"{_FRONTEND_INPUTS[cfg.family]}, the stubbed frontend's "
                "embeddings, which the synthetic token producer does not "
                "make: pass --stub-frontend to draw them at random, or "
                "train it through repro_torch.train.trainer.Trainer(..., "
                "producer=...) with a producer that adds them")
        producer = _stub_frontend_producer(cfg, shape.seq_len)

    tcfg = TrainerConfig(steps=args.steps, log_every=1,
                         ckpt_dir=args.ckpt_dir,
                         heartbeat_dir=args.heartbeat_dir, host_id=rank,
                         n_hosts=world)
    opt = make_optimizer("adamw", state_dtype=STATE_DTYPE[args.optimizer])
    trainer = Trainer(build_model(cfg), opt, shape, tcfg,
                      producer=producer, microbatches=args.microbatches,
                      device=device, mesh=mesh)
    out = trainer.run()
    if rank == 0:
        print(f"final loss: {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
