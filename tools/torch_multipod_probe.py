#!/usr/bin/env python3
"""The pod axis's traffic of each arch's train step, on four cards.

    python3 tools/torch_multipod_probe.py [ARCH ...] [--out DIR]
    python3 tools/torch_multipod_probe.py llama3.2-3b --device cpu \
        --test-mesh

The port's counterpart of ``results/multipod_probe.py``.  For each arch
(default: every registered one) it dry-runs ``train_4k``'s step
(``launch/dryrun.py:run_mesh_cell``: one sharded step under the cost
probe's counters, the reference's optimizer-state dtype for the arch) on
the single-pod mesh (data 1, model 2) over two ranks and on the multi-pod
mesh (pod 2, data 1, model 2) over four, each a world of processes of
its own spawned here, one card a rank (gloo ranks with ``--device cpu``).
Each batch rank takes one sequence of the shape's in both, so the model
axis carries the same traffic in the two steps and the difference of
their collective bytes a rank is the pod axis's: the all-reduce over
``pod`` of every gradient block, the loss and the squared gradient norm.
(The reference keeps the global batch on both meshes, so a device of its
multi-pod mesh takes half the rows, and its difference, clamped at 0,
also takes off the model axis's traffic of the rows it no longer
holds.)

It writes ``<out>/multipod_pod_axis.json`` (default ``build/torch_dryrun``,
beside the two records ``<arch>__train_4k__1x2.json`` and
``__2x1x2.json``), one entry per arch with the reference's keys:

* ``coll_singlepod``, ``coll_multipod``: the records' ``collective_bytes``;
* ``pod_axis_bytes``: their difference, beside ``reckoned_pod_axis_bytes``,
  the bytes of the rank's gradient blocks (fp32) and two fp32 scalars,
  from the placements alone (an MoE step also sums its routers'
  fractions over the batch axes, a few hundred bytes the reckoning
  leaves out);
* ``t_nvlink_s``: those bytes at the card's NVLink rate of one direction
  (``launch/hw.py``); ``t_nvlink_ef_int8_s``: a quarter of them, the
  reference's estimate for its int8 error-feedback pod all-reduce
  (``optim/compression.py:compressed_psum_pod``); ``t_nvlink_singlepod_s``:
  the single-pod step's collective bytes at that rate.  The reference's
  ``t_dcn_s`` divides by a TPU host's network rate, which prices no link
  of this machine and is not carried over.

An arch whose parameters, gradients and AdamW moments a rank (by the
multi-pod placements) exceed the card's memory is not run: its entry
has ``status`` ``does_not_fit``, as the dry run records it, with
``reckoned_bytes_per_rank``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import uuid
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

SHAPE = "train_4k"
SINGLE = ((1, 2), ("data", "model"))
MULTI = ((2, 1, 2), ("pod", "data", "model"))
OUT = ROOT / "build" / "torch_dryrun"


def _cell(arch: str, test_mesh: bool, batch: int):
    """(config, shape) of the arch's step: the registry's at full size
    (attention through the flash kernel), or the reduced config at
    sequence 64 (``--test-mesh``); ``batch`` sequences, one a batch
    rank."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.models.model import reduce_config
    cfg, shape = ARCHS[arch], SHAPES[SHAPE]
    if test_mesh:
        cfg, shape = reduce_config(cfg), dataclasses.replace(shape,
                                                             seq_len=64)
    else:
        cfg = dataclasses.replace(cfg, attention_impl="pallas")
    return cfg, dataclasses.replace(shape, global_batch=batch)


def reckon(arch: str, test_mesh: bool) -> dict:
    """A multi-pod rank's resident bytes (fp32 parameters and gradients,
    the AdamW moments in the arch's dtype) and the bytes its gradient
    blocks put on the pod axis, from the placements of an abstract mesh
    (no devices)."""
    from repro_torch.launch.dryrun import OPT_STATE_DTYPE
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train.step import _moment_shapes, make_train_step
    cfg, shape = _cell(arch, test_mesh, MULTI[0][0] * MULTI[0][1])
    model = build_model(cfg)
    opt = make_optimizer("adamw",
                         state_dtype=OPT_STATE_DTYPE.get(arch, "float32"))
    bundle = make_train_step(model, opt, shape, mesh=Mesh(*MULTI))
    p_shard, o_shard, _ = bundle.in_shardings
    shapes = model.param_shapes()
    blocks = sum(math.prod(p_shard[n].shard_shape(s))
                 for n, s in shapes.items())
    moments = _moment_shapes(opt, shapes)["mu"]
    moment_bytes = 0
    for n, mv in moments.items():
        for k, s in mv.items():
            sh = o_shard["mu"][n][k]
            if isinstance(s, dict):                    # int8 q and scale
                moment_bytes += math.prod(sh["q"].shard_shape(s["q"])) \
                    + 4 * math.prod(sh["scale"].shard_shape(s["scale"]))
            else:
                moment_bytes += 4 * math.prod(sh.shard_shape(s))
    return {"bytes_per_rank": 8 * blocks + moment_bytes,
            "pod_axis_bytes": 4 * blocks + 8}


def _rank(rank: int, world: int, arch: str, mesh_spec, test_mesh: bool,
          on_card: bool, out_dir: str, rendezvous: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=timedelta(minutes=10))
    try:
        shape, axes = mesh_spec
        mesh = make_mesh(shape, axes, device=device.type)
        batch = math.prod(shape[:-1])          # one sequence a batch rank
        cfg, cell = _cell(arch, test_mesh, batch)
        dryrun.run_mesh_cell(arch, SHAPE, mesh, Path(out_dir), cfg=cfg,
                             shape=cell, device=device)
    finally:
        dist.destroy_process_group()


def _spawn(arch: str, mesh_spec, args, on_card: bool) -> dict:
    """Run the cell on ``mesh_spec`` in a world of its own; rank 0's
    record."""
    import torch.multiprocessing as mp

    from repro_torch.launch.dryrun import mesh_name
    from repro_torch.launch.mesh import Mesh
    shape, axes = mesh_spec
    world = math.prod(shape)
    out = Path(args.out).resolve()        # file:// takes an absolute path
    out.mkdir(parents=True, exist_ok=True)
    rendezvous = out / f"rendezvous_{uuid.uuid4().hex}"
    try:
        mp.spawn(_rank, args=(world, arch, mesh_spec, args.test_mesh,
                              on_card, str(out), str(rendezvous)),
                 nprocs=world, join=True)
    finally:
        rendezvous.unlink(missing_ok=True)
    name = f"{arch}__{SHAPE}__{mesh_name(Mesh(shape, axes))}.json"
    return json.loads((out / name).read_text())


def probe(arch: str, args, on_card: bool, capacity: float) -> dict:
    """One arch's entry."""
    from repro_torch.launch import hw
    reckoned = reckon(arch, args.test_mesh)
    entry = {"arch": arch, "shape": SHAPE,
             "reckoned_bytes_per_rank": reckoned["bytes_per_rank"],
             "capacity_bytes": capacity,
             "reckoned_pod_axis_bytes": reckoned["pod_axis_bytes"]}
    if reckoned["bytes_per_rank"] > capacity:
        return {**entry, "status": "does_not_fit"}
    try:
        single = _spawn(arch, SINGLE, args, on_card)
        multi = _spawn(arch, MULTI, args, on_card)
    except Exception as e:  # noqa: BLE001 (record the failure, go on)
        return {**entry, "status": "error", "error": str(e)[-2000:]}
    c_single = single["collectives"]["collective_bytes"]
    c_multi = multi["collectives"]["collective_bytes"]
    pod = max(c_multi - c_single, 0)
    link = hw.LINK_BYTES_PER_S
    return {**entry, "status": "ok", "device": multi["device"],
            "records": [f"{arch}__{SHAPE}__{single['mesh_shape']}.json",
                        f"{arch}__{SHAPE}__{multi['mesh_shape']}.json"],
            "seq_len": multi["seq_len"],
            "rows_per_batch_rank": 1,
            "coll_singlepod": c_single, "coll_multipod": c_multi,
            "pod_axis_bytes": pod,
            "link_bytes_per_s": link,
            "t_nvlink_s": pod / link,
            "t_nvlink_ef_int8_s": pod / 4.0 / link,
            "t_nvlink_singlepod_s": c_single / link,
            "step_s_singlepod": single["step_s"],
            "step_s_multipod": multi["step_s"],
            "measured_peak_bytes_multipod": multi["measured_peak_bytes"]}


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.launch import hw
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*", help="arch ids (default: all)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs gloo ranks on the host (default: the "
                         "cards)")
    ap.add_argument("--test-mesh", action="store_true",
                    help="the reduced configs at sequence 64")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    on_card = args.device != "cpu"
    if on_card and torch.cuda.device_count() < math.prod(MULTI[0]):
        print(f"torch_multipod_probe: needs {math.prod(MULTI[0])} CUDA "
              f"cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    capacity = hw.peaks().hbm_bytes if on_card else hw.HBM_BYTES
    out = {}
    for arch in args.archs or list(ARCHS):
        out[arch] = probe(arch, args, on_card, capacity)
        print(arch, json.dumps(out[arch], indent=1), flush=True)
    path = Path(args.out) / "multipod_pod_axis.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    return 1 if any(e["status"] == "error" for e in out.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
