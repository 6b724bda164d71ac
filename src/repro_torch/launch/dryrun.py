"""Dry run: the cost probe of every (arch x shape) cell on one card.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--force] \
        [--microbatch N] [--device cpu] [--out DIR]

The single-card counterpart of ``repro/launch/dryrun.py``, which lowers
and compiles each cell against a TPU pod mesh.  Here each cell runs its
cost probe (``launch/probe.py``: one micro-batch at one and two periods,
in probe mode, extrapolated) and writes one JSON record to
``build/torch_dryrun/<arch>__<shape>__1gpu.json``:

* ``status``: ``ok``; ``skipped`` (``shape_applicable``);
  ``does_not_fit`` (one period at the smallest micro-batch exceeds the
  card's memory); ``error`` with its traceback;
* ``probe``: the extrapolated FLOPs and bytes with their parts;
* ``microbatch`` (sequences) and ``microbatches``: the cut of the
  shape's global batch the step is counted at.  Train and prefill take
  one sequence at a time; a decode step takes the largest power of two
  whose parameters and decode state fit the card;
* ``reckoned``: the resident bytes of the full-depth step (parameters,
  plus grads and AdamW state for train, plus the KV or SSM state at the
  micro-batch for decode) against the card's memory;
* ``measured_peak_bytes``: on the card, the probes' ``max_memory_allocated``
  extrapolated to full depth (None on the CPU);
* ``timing``: the probe's seconds.

It runs on the card unless given ``--device cpu``; at full size a cell
needs the card's memory, so the CPU takes reduced configs
(``launch.train --dry-run --test-mesh --device cpu``).

:func:`run_mesh_cell` is the mesh's record: every rank of an initialised
world runs one sharded step of the cell (``train/step.py:build_step``:
train with the reference's optimizer-state dtype, prefill, or decode,
``long_500k`` included) and rank 0 writes
``<arch>__<shape>__<data>x<model>.json`` (a pod mesh's
``<pod>x<data>x<model>``, its ``"mesh"`` marked ``"multipod"`` as the
reference marks its (2, 16, 16) records) with the rank's counted FLOPs
and bytes, the step's collectives per kind (``launch/comm_analysis.py``:
the reference's ``per_op``, ``collective_operand_bytes``,
``collective_result_bytes``, ``collective_bytes``, and ``per_axis``), its
seconds, its loss and its roofline row with the collective term
(``launch.train --distributed [--multi-pod] --dry-run``).
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, SHAPES, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import hw
from repro_torch.launch.probe import run_probe

RESULTS = Path(__file__).resolve().parents[3] / "build" / "torch_dryrun"
MESH = "1gpu"


def _decode_state_bytes(cfg: ModelConfig, batch: int, max_seq: int) -> int:
    """Bytes of the full-depth decode state at ``batch``, allocated on the
    meta device (shapes only)."""
    from repro_torch.models.model import build_model
    state = build_model(cfg).decode_init(batch, max_seq, device="meta")
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def choose_microbatch(cfg: ModelConfig, shape: ShapeConfig,
                      capacity: float) -> Optional[int]:
    """Sequences per micro-batch: 1 for train and prefill; for decode the
    largest power of two dividing the batch whose serving parameters
    (``param_count`` in the compute dtype) and decode state fit
    ``capacity`` bytes, or None if one sequence does not."""
    if shape.kind != "decode":
        return 1
    params = cfg.param_count() * 2
    b = 1
    while b * 2 <= shape.global_batch and shape.global_batch % (b * 2) == 0:
        b *= 2
    while b >= 1:
        if params + _decode_state_bytes(cfg, b, shape.seq_len) <= capacity:
            return b
        b //= 2
    return None


def reckoned_bytes(probe: Dict, kind: str, capacity: float) -> Dict:
    """The step's resident bytes at full depth: the parameters as the
    model holds them, fp32 grads and two fp32 AdamW moments for train,
    the decode state for decode."""
    params = probe["param_bytes"]
    out = {"param_bytes": params, "grad_bytes": 0.0, "optimizer_bytes": 0.0,
           "state_bytes": 0.0}
    if kind == "train":
        out["grad_bytes"] = params
        out["optimizer_bytes"] = 2 * params
    if kind == "decode":
        out["state_bytes"] = probe["state_bytes"] / probe["microbatches"]
    out["total_bytes"] = sum(out.values())
    out["capacity_bytes"] = capacity
    out["fits"] = out["total_bytes"] <= capacity
    return out


def run_cell(arch: str, shape_name: str, out_dir: Path = RESULTS, *,
             force: bool = False, microbatch: Optional[int] = None,
             device: DeviceLike = None, cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict:
    """Probe one cell and write its record (or return the one on disk
    unless ``force``).  ``cfg`` and ``shape`` override the registry's (a
    reduced config for the CPU)."""
    out_path = Path(out_dir) / f"{arch}__{shape_name}__{MESH}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": MESH,
                 "kind": shape.kind, "seq_len": shape.seq_len,
                 "global_batch": shape.global_batch,
                 "status": "skipped", "skip_reason": why}
    if ok:
        dev = resolve_device(device)
        on_card = dev.type == "cuda"
        capacity = hw.peaks().hbm_bytes if on_card else hw.HBM_BYTES
        rec["device"] = torch.cuda.get_device_name(dev) if on_card \
            else "cpu"
        try:
            rec.update(_probe_cell(cfg, shape, dev, capacity, microbatch))
        except torch.cuda.OutOfMemoryError as e:
            rec.update({"status": "does_not_fit", "error": str(e)})
        except Exception as e:  # noqa: BLE001 (record the failure, go on)
            rec.update({"status": "error", "error": str(e),
                        "traceback": traceback.format_exc()[-4000:]})
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def _probe_cell(cfg, shape, dev, capacity, microbatch) -> Dict:
    from repro_torch.launch.roofline import matmul_params
    mb = microbatch or choose_microbatch(cfg, shape, capacity)
    if mb is None:
        return {"status": "does_not_fit",
                "error": "one sequence's decode state and the parameters "
                         "exceed the card's memory"}
    if shape.global_batch % mb:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"micro-batches of {mb}")
    t0 = time.perf_counter()
    probe = run_probe(cfg, shape, microbatches=shape.global_batch // mb,
                      device=dev)
    seconds = time.perf_counter() - t0
    return {"status": "ok", "microbatch": mb,
            "microbatches": shape.global_batch // mb,
            "param_count": cfg.param_count(),
            "active_param_count": cfg.active_param_count(),
            "matmul_param_count": matmul_params(cfg),
            "probe": probe,
            "reckoned": reckoned_bytes(probe, shape.kind, capacity),
            "measured_peak_bytes": probe["peak_bytes"],
            "timing": {"probe_s": seconds}}


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def mesh_kind(mesh) -> str:
    """A record's ``"mesh"``: ``multipod`` for a mesh with a ``pod``
    axis (the reference's name), else its shape."""
    return "multipod" if "pod" in mesh.shape else mesh_name(mesh)


# the reference's optimizer-state dtype a cell trains with (int8 blocks for
# the two largest models, fp32 elsewhere): repro/launch/dryrun.py
OPT_STATE_DTYPE = {
    "qwen3-moe-235b-a22b": "int8",
    "granite-34b": "int8",
}


def run_mesh_cell(arch: str, shape_name: str, mesh, out_dir: Path = RESULTS,
                  *, cfg: Optional[ModelConfig] = None,
                  shape: Optional[ShapeConfig] = None,
                  microbatches: int = 1, device: DeviceLike = None,
                  seed: int = 0) -> Dict:
    """One sharded step of the cell on ``mesh`` (every rank calls this,
    with the same arguments), built by ``train/step.py:build_step`` for
    the shape's kind: a train step with AdamW moments of the reference's
    dtype for the arch (:data:`OPT_STATE_DTYPE`), a prefill step,
    or a decode step of one token per sequence against a full cache.
    Random parameters from ``seed``, a batch of random tokens (and, for
    a multimodal family, its frontend's embeddings) from it.  The step
    runs under the cost probe's counters (``probe.counting``): the
    record holds this rank's FLOPs and bytes, its collectives, its
    seconds and its loss (train), so the roofline has all three terms
    (``roofline.analyze_cell``; the kernels' terms as
    :func:`mesh_probe` adds them).  Rank 0 writes the record and every
    rank returns it."""
    import torch.distributed as dist

    from repro_torch.launch.comm_analysis import analyze_collectives
    from repro_torch.launch.probe import counting
    from repro_torch.launch.roofline import analyze_cell, matmul_params
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.sharding import collectives as C
    from repro_torch.train.step import build_step
    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    dev = resolve_device(device)
    model = build_model(cfg)
    train, decode = shape.kind == "train", shape.kind == "decode"
    state_dtype = OPT_STATE_DTYPE.get(arch, "float32")
    gen = torch.Generator(dev).manual_seed(seed)
    tokens = (shape.global_batch,) if decode \
        else (shape.global_batch, shape.seq_len)
    batch = {"tokens": torch.randint(0, cfg.vocab, tokens, generator=gen,
                                     device=dev)}
    if cfg.family == "vlm" and not decode:
        batch["image_embeds"] = torch.randn(
            shape.global_batch, cfg.image_tokens, cfg.d_model,
            generator=gen, device=dev)
    if cfg.family == "audio" and not decode:
        batch["enc_frames"] = torch.randn(
            shape.global_batch, cfg.encoder_seq, cfg.d_model,
            generator=gen, device=dev)
    opt = make_optimizer("adamw", state_dtype=state_dtype) if train \
        else None
    bundle = build_step(model, opt, mesh, shape, microbatches=microbatches)
    params = bundle.shard_params(model.init(seed, device=dev,
                                            trainable=train))
    if train:
        batch["targets"] = batch["tokens"].roll(-1, dims=1)
        args = (params, bundle.init_state(params), batch)
    elif decode:
        batch["cache_len"] = torch.full((shape.global_batch,),
                                        shape.seq_len - 1, device=dev)
        args = (params, bundle.init_state(dev), batch)
    else:
        args = (params, batch)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    C.reset_tally()
    t0 = time.perf_counter()
    with counting() as (fc, bc), C.record_calls() as calls:
        out = bundle(*args)
        loss = float(out[2]["loss"]) if train else None
    seconds = time.perf_counter() - t0
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind(mesh),
           "mesh_shape": mesh_name(mesh), "axes": list(mesh.axis_names),
           "chips": math.prod(mesh.shape.values()), "kind": shape.kind,
           "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "microbatches": microbatches, "status": "ok",
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "state_dtype": state_dtype if train else None,
           "matmul_param_count": matmul_params(cfg),
           "probe": mesh_probe(cfg, shape, mesh, fc, bc, on_card),
           "collectives": analyze_collectives(calls=calls),
           "step_s": seconds,
           "measured_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                   if on_card else None),
           "loss": loss}
    rec["roofline"] = analyze_cell(rec)
    if dist.get_rank() == 0:
        out_path = Path(out_dir) / \
            f"{arch}__{shape_name}__{mesh_name(mesh)}.json"
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
    return rec


def mesh_probe(cfg: ModelConfig, shape: ShapeConfig, mesh, fc, bc,
               on_card: bool) -> Dict:
    """A rank's FLOPs and bytes of a sharded step from the cost probe's
    counters (``fc``, ``bc``: ``probe.counting``) around it.  On the card
    the hand-written kernels are calls the counters do not see: their
    analytic terms (``costs.kernel_true``) are added, split evenly over
    the ranks that split the model and the batch (``kernel_share``, an
    estimate); on the CPU their plain twins were counted as they ran."""
    from repro_torch.launch import costs
    from repro_torch.sharding.api import activation_rules
    share = {"flops": 0.0, "bytes": 0.0}
    if on_card:
        split = mesh.shape.get("model", 1)
        for a in activation_rules(cfg, shape, mesh)["batch"] or ():
            split *= mesh.shape.get(a, 1)
        kt = costs.kernel_true(cfg, shape,
                               costs.skipped_kernels(cfg, shape.kind))
        share = {k: kt[k] / split for k in share}
    return {"flops": float(fc.get_total_flops()) + share["flops"],
            "bytes": float(bc.bytes) + share["bytes"],
            "kernel_share": share}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape (default: all)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="sequences per micro-batch (default: see module)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    counts: Dict[str, int] = {}
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, Path(args.out), force=args.force,
                           microbatch=args.microbatch, device=args.device)
            counts[rec["status"]] = counts.get(rec["status"], 0) + 1
            print(summary_line(rec), flush=True)
    print(f"\ndone: {counts}")
    return 1 if counts.get("error") else 0


def summary_line(rec: Dict) -> str:
    tag = f"{rec['arch']:24s} {rec['shape']:12s}"
    if rec["status"] == "ok":
        p, r = rec["probe"], rec["reckoned"]
        peak = rec["measured_peak_bytes"]
        return (f"OK    {tag} mb={rec['microbatch']}x{rec['microbatches']} "
                f"flops={p['flops']:.3e} bytes={p['bytes']:.3e} "
                f"reckoned={r['total_bytes'] / 1e9:.2f}GB "
                f"peak={'n/a' if peak is None else f'{peak / 1e9:.2f}GB'} "
                f"probe={rec['timing']['probe_s']:.1f}s")
    if rec["status"] == "skipped":
        return f"SKIP  {tag} ({rec['skip_reason'][:60]})"
    return f"{rec['status'].upper():5s} {tag} {rec.get('error', '')[:120]}"


if __name__ == "__main__":
    raise SystemExit(main())
