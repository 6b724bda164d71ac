"""Per-rank bodies of the port's multi-rank CPU tests, run by
``tests/torch_dist_util.py`` on a gloo world.  Each reads its inputs from
``outdir`` and rank 0 writes the results there (every rank takes part in
the gathers).  They import torch and the port only: the tests hold the
results to the JAX reference in their own process."""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import adamw_state_from_numpy, params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model, reduce_config
from repro_torch.optim.optimizers import Optimizer, make_optimizer
from repro_torch.sharding import api
from repro_torch.sharding import collectives as C
from repro_torch.train.step import make_prefill_step, make_train_step


# a mesh's axes by its rank: (data, model), or the multi-pod (pod, data,
# model)
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def _mesh(shape):
    return make_mesh(shape, AXES[len(shape)], device="cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _capturing(opt: Optimizer, into: dict) -> Optimizer:
    """``opt`` whose update first keeps a copy of the grads it is given
    (this rank's blocks, after every reduction)."""
    def update_(grads, state, params, *rest):
        into.update({n: g.detach().clone() for n, g in grads.items()})
        opt.update_(grads, state, params, *rest)
    return dataclasses.replace(opt, update_=update_)


@contextlib.contextmanager
def _record_routing():
    """Yields the list of every MoE layer's top-k expert indices (G, S, k)
    of this rank's rows, in call order."""
    from repro_torch.models import moe
    real, found = moe._top_k_mask, []

    def spy(probs, k):
        found.append(torch.topk(probs, k, dim=-1)[1].detach())
        return real(probs, k)

    moe._top_k_mask = spy
    try:
        yield found
    finally:
        moe._top_k_mask = real


def _gather_tree(values: dict, shardings: dict) -> dict:
    return {n: _np(C.gather_global(v, shardings[n]))
            for n, v in values.items()}


def train(rank: int, world: int, outdir: Path, stem: str = "train"
          ) -> None:
    """Every (mesh, config, FSDP, micro-batches) case of
    ``tests/test_torch_dist_train.py`` (``<stem>_in.pt``; ``stem``
    "families": ``tests/test_torch_dist_families.py``): one AdamW step
    from the reference's parameters, its loss, its reduced grads and its
    updated parameters, all gathered; then the prefill logits."""
    inp = torch.load(outdir / f"{stem}_in.pt", weights_only=False)
    out = {}
    for mesh_shape in inp["meshes"]:
        mesh = _mesh(mesh_shape)
        mkey = "x".join(map(str, mesh_shape))
        for case in inp["cases"]:
            if case.get("mesh") not in (None, mkey):
                continue
            name, fsdp, mb = case["config"], case["fsdp"], case["mb"]
            arch, over = inp["configs"][name]
            cfg = reduce_config(ARCHS[arch], **over)
            model = build_model(cfg)
            batch = {k: torch.from_numpy(v)
                     for k, v in inp["batches"][name].items()}
            api.set_overrides(fsdp=fsdp)
            try:
                if case["kind"] == "prefill":
                    bundle = make_prefill_step(model, mesh=mesh)
                    params = params_from_numpy(
                        inp["trees"][name], cfg, "cpu",
                        shardings=bundle.in_shardings[0])
                    logits = bundle(params, batch)
                    full = C.gather_global(logits, bundle.out_shardings)
                    out[(mkey, name, "prefill")] = _np(full)
                    continue
                grads = {}
                opt = _capturing(make_optimizer("adamw", lr=1e-2), grads)
                routing = _record_routing() if case.get("routing") \
                    else contextlib.nullcontext([])
                shape = ShapeConfig("t", batch["tokens"].shape[1],
                                    batch["tokens"].shape[0], "train")
                bundle = make_train_step(model, opt, shape, mesh=mesh,
                                         microbatches=mb)
                p_shard, o_shard, _ = bundle.in_shardings
                params = params_from_numpy(inp["trees"][name], cfg, "cpu",
                                           trainable=True,
                                           shardings=p_shard)
                state = bundle.init_state(params)
                with routing as chosen:
                    _, _, metrics = bundle(params, state, batch)
                m_shard = {n: o_shard["mu"][n]["m"] for n in grads}
                out[(mkey, name, fsdp, mb)] = {
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "grads": _gather_tree(grads, m_shard),
                    "params": _gather_tree(
                        dict(params.named_parameters()), p_shard),
                    "moments": _gather_tree(
                        {n: state["mu"][n]["m"] for n in grads}, m_shard),
                    # each MoE layer's top-k choices, the global batch's
                    "routing": [_np(C.all_gather(t, "data", 0, mesh=mesh))
                                for t in chosen],
                }
            finally:
                api.clear_overrides()
    if rank == 0:
        torch.save(out, outdir / f"{stem}_out.pt")


def families(rank: int, world: int, outdir: Path, *,
             rendezvous: str) -> None:
    """``tests/test_torch_dist_families.py``: the sharded steps of
    :func:`train` on the hybrid, MoE and audio families; the MoE
    auxiliary loss of one layer on (2, 2) against the one-device value;
    then ``launch.train --distributed`` on zamba2, granite-moe and
    whisper, each a world of its own as torchrun would start it."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.models import moe
    from repro_torch.sharding.rules import use_mesh
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        train(rank, world, outdir, stem="families")
        inp = torch.load(outdir / "families_in.pt", weights_only=False)
        arch, over = inp["aux"]["config"]
        cfg = reduce_config(ARCHS[arch], **over)
        x = torch.from_numpy(inp["aux"]["x"])
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        model = build_model(cfg)
        p_shard = api.param_shardings(mesh, cfg, model.param_specs(),
                                      model.param_shapes())
        shape = ShapeConfig("t", x.shape[1], x.shape[0], "train")
        params = params_from_numpy(inp["trees"][inp["aux"]["tree"]], cfg,
                                   "cpu", trainable=True, shardings=p_shard)
        layer = params.blocks[0].moe
        act = api.activation_rules(cfg, shape, mesh)
        rows = x.shape[0] // 2
        mine = x[mesh.coords()["data"] * rows:][:rows]
        with use_mesh(mesh, act):
            _, aux = moe.moe_forward(cfg, layer, mine)
        with use_mesh(None):
            # the same rows without the batch axes' sums: a mean over this
            # rank's tokens only
            full = {k: C.gather_global(v.detach(), p_shard[
                f"blocks.0.moe.{k}"]) for k, v in layer.items()}
            _, local = moe.moe_forward(cfg, full, mine)
        auxes = C.all_gather(torch.stack([aux.detach(), local])[None],
                             "data", 0, mesh=mesh)

        # every collective of one zamba2 step with remat on (each mamba
        # layer replayed in the backward), in order, on every rank
        name = inp["order"]
        cfg = reduce_config(ARCHS[inp["configs"][name][0]],
                            **inp["configs"][name][1])
        batch = {k: torch.from_numpy(v)
                 for k, v in inp["batches"][name].items()}
        bundle = make_train_step(
            build_model(cfg), make_optimizer("adamw"),
            ShapeConfig("t", batch["tokens"].shape[1],
                        batch["tokens"].shape[0], "train"), mesh=mesh)
        params = params_from_numpy(inp["trees"][name], cfg, "cpu",
                                   trainable=True,
                                   shardings=bundle.in_shardings[0])
        state = bundle.init_state(params)
        with C.record_calls() as calls:
            bundle(params, state, batch)
        order = [None] * world
        dist.all_gather_object(order, [(c["kind"], c["axis"],
                                        c["operand_shape"]) for c in calls])
        if rank == 0:
            torch.save({"aux": _np(auxes), "order": order},
                       outdir / "aux_out.pt")
    finally:
        dist.destroy_process_group()

    from repro_torch.launch import train as launch
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    runs = {}
    for arch in inp["launch"]:
        out = launch.main(["--arch", arch, "--test-mesh", "--device",
                           "cpu", "--steps", "2", "--distributed",
                           "--stub-frontend",
                           "--dist-init", f"file://{rendezvous}_{arch}"])
        runs[arch] = out["history"]
    if rank == 0:
        torch.save(runs, outdir / "launch_families_out.pt")


def pipeline(rank: int, world: int, outdir: Path) -> None:
    """``pipeline_apply`` and the gradient of ``pipeline_loss`` on 4
    stages, each rank one stage."""
    from repro_torch.train.pipeline import (pipeline_apply, pipeline_loss,
                                            split_microbatches)
    inp = np.load(outdir / "pipe_in.npz")
    mesh = make_mesh((world,), ("stage",), device="cpu")
    w = torch.from_numpy(inp["ws"][rank]).requires_grad_()

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])

    m = int(inp["M"])
    xs = split_microbatches(torch.from_numpy(inp["x"]), m)
    out = pipeline_apply(stage_fn, {"w": w}, xs, mesh=mesh, axis="stage")
    xg = split_microbatches(torch.from_numpy(inp["xg"]), int(inp["Mg"]))
    tg = split_microbatches(torch.from_numpy(inp["tg"]), int(inp["Mg"]))
    loss = pipeline_loss(stage_fn, lambda y, t: torch.mean((y - t) ** 2),
                         {"w": w}, xg, tg, mesh=mesh, axis="stage")
    loss.backward()
    grads = C.all_gather(w.grad[None], "stage", 0, mesh=mesh)
    if rank == 0:
        np.savez(outdir / "pipe_out.npz", out=_np(out), loss=_np(loss),
                 grads=_np(grads))


def misc(rank: int, world: int, outdir: Path) -> None:
    """On 4 ranks: ``compressed_psum_pod`` over a pod group of 2 (each
    rank writes its result); two steps' collective tallies on (2, 2) with
    FSDP; ``adamw_state_from_numpy`` onto (2, 2); a sharded checkpoint
    of the stepped state saved at (2, 2) and restored at (4, 1) without
    FSDP."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.optim.compression import compressed_psum_pod
    from repro_torch.sharding.rules import use_mesh
    inp = torch.load(outdir / "misc_in.pt", weights_only=False)
    res = {}

    # compression over pod (the (pod, data) mesh's first axis)
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    g = {k: torch.from_numpy(v[rank]) for k, v in inp["grads"].items()}
    e = {k: torch.from_numpy(v[rank]) for k, v in inp["residual"].items()}
    with use_mesh(mesh):
        mean, new_res = compressed_psum_pod(g, e, "pod")
    torch.save({"mean": {k: _np(v) for k, v in mean.items()},
                "residual": {k: _np(v) for k, v in new_res.items()}},
               outdir / f"compress_{rank}.pt")

    # the collectives of two train steps on (2, 2), FSDP on
    arch, over = inp["config"]
    cfg = reduce_config(ARCHS[arch], **over)
    model = build_model(cfg)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    shape = ShapeConfig("t", batch["tokens"].shape[1],
                        batch["tokens"].shape[0], "train")
    api.set_overrides(fsdp=True)
    try:
        bundle = make_train_step(model, make_optimizer("adamw"), shape,
                                 mesh=mesh)
        params = params_from_numpy(inp["tree"], cfg, "cpu", trainable=True,
                                   shardings=bundle.in_shardings[0])
        state = bundle.init_state(params)
        steps = []
        for _ in range(2):
            C.reset_tally()
            with C.record_calls() as calls:
                bundle(params, state, batch)
            steps.append({"tally": C.tally(), "calls": calls})
        res["tally"] = {"steps": steps,
                        "local": {n: tuple(p.shape)
                                  for n, p in params.named_parameters()},
                        "global": model.param_shapes()}

        # the reference's AdamW state carried onto the mesh
        m_shard = {n: v["m"] for n, v in bundle.in_shardings[1]["mu"].items()}
        carried = adamw_state_from_numpy(inp["state"], cfg, "cpu",
                                         shardings=m_shard)
        res["adamw_state"] = {
            n: {k: _np(C.gather_global(mv[k], m_shard[n])) for k in mv}
            for n, mv in carried["mu"].items()}

        # a checkpoint of the stepped state, saved by every rank at (2, 2)
        ckpt = CheckpointManager(str(outdir / "ckpt"), host_id=rank,
                                 n_hosts=world)
        named = dict(params.named_parameters())
        ckpt.save(2, (named, state), {"epoch": 0, "index": 16},
                  blocking=True, shardings=bundle.in_shardings[:2])
        p_shard, o_shard, _ = bundle.in_shardings
        res["saved"] = {
            "params": _gather_tree(named, p_shard),
            "m": _gather_tree({n: state["mu"][n]["m"] for n in named},
                              {n: o_shard["mu"][n]["m"] for n in named}),
            "count": int(state["count"])}
    finally:
        api.clear_overrides()
    torch.distributed.barrier()

    # ... restored on (4, 1) without FSDP
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    api.set_overrides(fsdp=False)
    try:
        bundle = make_train_step(model, make_optimizer("adamw"), shape,
                                 mesh=mesh)
        fresh = bundle.shard_params(model.init(7, device="cpu",
                                               trainable=True))
        state = bundle.init_state(fresh)
        named = dict(fresh.named_parameters())
        mgr = CheckpointManager(str(outdir / "ckpt"), host_id=rank,
                                n_hosts=world)
        _, ds = mgr.restore(mgr.latest_step(), (named, state),
                            shardings=bundle.in_shardings[:2])
        p_shard, o_shard, _ = bundle.in_shardings
        res["restored"] = {
            "params": _gather_tree(named, p_shard),
            "m": _gather_tree({n: state["mu"][n]["m"] for n in named},
                              {n: o_shard["mu"][n]["m"] for n in named}),
            "count": int(state["count"]), "data_state": ds}
    finally:
        api.clear_overrides()
    if rank == 0:
        torch.save(res, outdir / "misc_out.pt")


def launch_train(rank: int, world: int, outdir: Path, *,
                 rendezvous: str) -> None:
    """``launch.train --distributed --test-mesh --device cpu`` as torchrun
    would start it on this rank (it joins the world itself)."""
    import os

    from repro_torch.launch import train as launch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    out = launch.main(["--arch", "llama3.2-3b", "--test-mesh", "--device",
                       "cpu", "--steps", "2", "--distributed",
                       "--dist-init", f"file://{rendezvous}",
                       "--ckpt-dir", str(outdir / "ckpt")])
    rec = launch.main(["--arch", "llama3.2-3b", "--test-mesh", "--device",
                       "cpu", "--distributed", "--dry-run",
                       "--dist-init", f"file://{rendezvous}_dry",
                       "--dryrun-dir", str(outdir / "dryrun")])
    # int8 moments at a batch of 1, which the (2, 2) mesh does not split
    int8 = launch.main(["--arch", "llama3.2-3b", "--test-mesh", "--device",
                        "cpu", "--steps", "2", "--distributed",
                        "--optimizer", "adamw_int8", "--batch", "1",
                        "--dist-init", f"file://{rendezvous}_int8"])
    if rank == 0:
        torch.save({"history": out["history"],
                    "final_loss": out["final_loss"], "dry_run": rec,
                    "int8_history": int8["history"]},
                   outdir / "launch_out.pt")


def launch_multi_pod(rank: int, world: int, outdir: Path, *,
                     rendezvous: str, extra: list, refusal) -> None:
    """``launch.train --distributed --multi-pod --test-mesh --device cpu``
    (two steps, or ``extra``'s run) as torchrun would start it on this
    rank; where ``refusal`` names the error it expects, the message."""
    import os

    from repro_torch.launch import train as launch
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    argv = ["--arch", "llama3.2-3b", "--test-mesh", "--device", "cpu",
            "--steps", "2", "--distributed", "--multi-pod",
            "--dist-init", f"file://{rendezvous}",
            "--dryrun-dir", str(outdir / "dryrun")] + extra
    if refusal is not None:
        try:
            launch.main(argv)
        except ValueError as e:
            out = {"refused": str(e)}
        else:
            out = {"refused": ""}
    else:
        out = launch.main(argv)
        out = {"history": out.get("history")}
    if rank == 0:
        torch.save(out, outdir / "launch_multi_pod_out.pt")


def xlstm(rank: int, world: int, outdir: Path, *, rendezvous: str) -> None:
    """``tests/test_torch_dist_xlstm.py``: the sharded steps of
    :func:`train` on the xLSTM family, then ``launch.train --distributed
    --arch xlstm-1.3b`` in a world of its own, as torchrun would start
    it."""
    import os
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch import train as launch
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        train(rank, world, outdir, stem="xlstm")
    finally:
        dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    out = launch.main(["--arch", "xlstm-1.3b", "--test-mesh", "--device",
                       "cpu", "--steps", "2", "--distributed",
                       "--dist-init", f"file://{rendezvous}_launch"])
    if rank == 0:
        torch.save(out["history"], outdir / "launch_xlstm_out.pt")


def decode(rank: int, world: int, outdir: Path, stem: str = "decode"
           ) -> None:
    """``tests/test_torch_dist_decode.py``: every (mesh, config) case's
    sharded decode steps over ``<stem>_in.pt``'s tokens and lengths from
    a zero state (the cross caches written from the input first): each
    step's logits and the final state, gathered."""
    from repro_torch.train.step import make_decode_step
    inp = torch.load(outdir / f"{stem}_in.pt", weights_only=False)
    out = {}
    b, length = inp["batch"], inp["max_seq"]
    shape = ShapeConfig("decode", length, b, "decode")
    for mesh_shape in inp["meshes"]:
        mesh = _mesh(mesh_shape)
        mkey = "x".join(map(str, mesh_shape))
        for name, (arch, over) in inp["configs"].items():
            cfg = reduce_config(ARCHS[arch], **over)
            model = build_model(cfg)
            bundle = make_decode_step(model, mesh=mesh, shape=shape)
            params = params_from_numpy(inp["trees"][name], cfg, "cpu",
                                       shardings=bundle.in_shardings[0])
            state = model.decode_init(b, length, device="cpu")
            for k, v in inp["cross"].get(name, {}).items():
                state[k].copy_(torch.from_numpy(v))
            state = bundle.shard_state(state)
            logits = []
            for tok, lens in zip(inp["tokens"][name], inp["lens"]):
                lg, state = bundle(params, state,
                                   {"tokens": torch.from_numpy(tok),
                                    "cache_len": torch.from_numpy(lens)})
                logits.append(_np(C.gather_global(
                    lg, bundle.out_shardings[0])))
            out[(mkey, name)] = {
                "logits": np.stack(logits),
                "state": _gather_state(state, bundle.in_shardings[1])}
    if rank == 0:
        torch.save(out, outdir / f"{stem}_out.pt")


def _gather_state(state, shardings):
    if isinstance(state, dict):
        return {k: _gather_state(v, shardings[k]) for k, v in state.items()}
    return _np(C.gather_global(state, shardings))


def _state_from_numpy(model, arrays: dict, batch: int, length: int):
    """The port's decode state holding ``arrays``' values (the
    reference's tree of the same keys and shapes)."""
    state = model.decode_init(batch, length, device="cpu")

    def fill(s, a):
        for k, v in a.items():
            if isinstance(v, dict):
                fill(s[k], v)
            else:
                assert tuple(s[k].shape) == v.shape, (k, v.shape)
                s[k].copy_(torch.from_numpy(v))
    fill(state, arrays)
    return state


def seqpar_runs(inp: dict, mesh=None) -> dict:
    """``tests/test_torch_dist_seqpar.py``'s runs on ``mesh`` (one rank
    without), from the reference's parameters (``inp["trees"]``): every
    decode config's steps at batch 1 from ``inp``'s state, then every
    train case's AdamW step and prefill.  With a mesh the results are
    gathered to their global values."""
    from repro_torch.train.step import make_decode_step
    out = {}
    for name, (arch, over) in inp["decode_configs"].items():
        model = build_model(reduce_config(ARCHS[arch], **over))
        cfg = model.cfg
        shape = ShapeConfig("decode", inp["max_seq"], 1, "decode")
        state = _state_from_numpy(model, inp["states"][name], 1,
                                  inp["max_seq"])
        if mesh is None:
            params = params_from_numpy(inp["trees"][name], cfg, "cpu")
            step, out_sh, s_sh = make_decode_step(model), None, None
        else:
            bundle = make_decode_step(model, mesh=mesh, shape=shape)
            params = params_from_numpy(inp["trees"][name], cfg, "cpu",
                                       shardings=bundle.in_shardings[0])
            state = bundle.shard_state(state)
            step, out_sh, s_sh = bundle, bundle.out_shardings[0], \
                bundle.in_shardings[1]
        logits = []
        for tok, lens in zip(inp["tokens"], inp["lens"]):
            lg, state = step(params, state,
                             {"tokens": torch.from_numpy(tok),
                              "cache_len": torch.from_numpy(lens)})
            logits.append(_np(lg if mesh is None
                              else C.gather_global(lg, out_sh)))
        out[("decode", name)] = {
            "logits": np.stack(logits),
            "state": torch.utils._pytree.tree_map(_np, state)
            if mesh is None else _gather_state(state, s_sh)}
    for name, b, fsdp in inp["train_cases"]:
        arch, over = inp["train_configs"][name]
        cfg = reduce_config(ARCHS[arch], **over)
        model = build_model(cfg)
        batch = {k: torch.from_numpy(v)
                 for k, v in inp["batches"][(name, b)].items()}
        shape = ShapeConfig("t", batch["tokens"].shape[1], b, "train")
        api.set_overrides(fsdp=fsdp)
        try:
            grads = {}
            opt = _capturing(make_optimizer("adamw", lr=1e-2), grads)
            bundle = make_train_step(model, opt, shape, mesh=mesh)
            params = bundle.shard_params(params_from_numpy(
                inp["trees"][name], cfg, "cpu", trainable=True))
            state = bundle.init_state(params)
            # the prefill first, on the parameters both sides share
            prefill = make_prefill_step(model, mesh=mesh, shape=dataclasses
                                        .replace(shape, kind="prefill"))
            logits = prefill(params, {"tokens": batch["tokens"]})
            _, _, metrics = bundle(params, state, batch)
            named = {n: p.data for n, p in params.named_parameters()}
            if mesh is not None:
                p_shard, o_shard, _ = bundle.in_shardings
                grads = {n: C.gather_global(g, o_shard["mu"][n]["m"])
                         for n, g in grads.items()}
                named = {n: C.gather_global(t, p_shard[n])
                         for n, t in named.items()}
                logits = C.gather_global(logits, prefill.out_shardings)
            out[("train", name, b, fsdp)] = {
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "grads": {n: _np(g) for n, g in grads.items()},
                "params": {n: _np(t) for n, t in named.items()},
                "logits": _np(logits)}
        finally:
            api.clear_overrides()
    return out


def seqpar(rank: int, world: int, outdir: Path) -> None:
    """``tests/test_torch_dist_seqpar.py``: :func:`seqpar_runs` on every
    mesh of ``seqpar_in.pt``."""
    inp = torch.load(outdir / "seqpar_in.pt", weights_only=False)
    out = {}
    for mesh_shape in inp["meshes"]:
        mesh = _mesh(mesh_shape)
        mkey = "x".join(map(str, mesh_shape))
        out.update({(mkey,) + k: v
                    for k, v in seqpar_runs(inp, mesh).items()})
    if rank == 0:
        torch.save(out, outdir / "seqpar_out.pt")


def int8_runs(inp: dict, mesh=None, fsdp=None, grads=None) -> dict:
    """``tests/test_torch_dist_int8.py``'s run on ``mesh`` (one rank
    without): ``inp``'s steps of int8 AdamW from the seed's parameters;
    each step's loss and whole gradients (on a mesh, each parameter's
    reduced gradient as the int8 update receives it, gathered whole),
    and the parameters and each moment's ``q`` and ``scale`` after them,
    gathered to their global values.  One rank given ``grads`` (a list of
    a step's whole gradients) applies the optimizer to them instead of
    its own."""
    from repro_torch.train import step as step_mod
    arch, over = inp["config"]
    cfg = reduce_config(ARCHS[arch], **over)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    shape = ShapeConfig("t", batch["tokens"].shape[1],
                        batch["tokens"].shape[0], "train")
    opt = make_optimizer("adamw", state_dtype="int8", lr=inp["lr"])
    seen = []
    if mesh is None:
        real = opt

        def update_(g, state, params):
            seen.append({n: _np(t) for n, t in g.items()})
            if grads is not None:
                g = {n: torch.from_numpy(grads[len(seen) - 1][n])
                     for n in g}
            real.update_(g, state, params)
        opt = dataclasses.replace(real, update_=update_)
    real_leaf = step_mod._int8_leaf_

    def spy(adamw, g, mv, p, p_shard, q_shard, corrections):
        seen[-1][p._name] = _np(g)
        real_leaf(adamw, g, mv, p, p_shard, q_shard, corrections)

    api.set_overrides(fsdp=fsdp)
    step_mod._int8_leaf_ = spy
    try:
        bundle = make_train_step(model, opt, shape, mesh=mesh)
        params = bundle.shard_params(model.init(0, device="cpu",
                                                trainable=True))
        for n, p in params.named_parameters():
            p._name = n
        state = bundle.init_state(params)
        losses = []
        for _ in range(inp["steps"]):
            if mesh is not None:
                seen.append({})
            _, _, metrics = bundle(params, state, batch)
            losses.append(float(metrics["loss"]))
        named = {n: p.data for n, p in params.named_parameters()}
        mu = state["mu"]
        blocks = {n: tuple(mv["m"]["q"].shape) for n, mv in mu.items()}
        if mesh is not None:
            p_shard, o_shard, _ = bundle.in_shardings
            named = {n: C.gather_global(t, p_shard[n])
                     for n, t in named.items()}
            mu = {n: {k: {part: C.gather_global(
                mv[k][part], o_shard["mu"][n][k][part])
                for part in ("q", "scale")} for k in ("m", "v")}
                for n, mv in mu.items()}
        return {"losses": losses, "grads": seen,
                "params": {n: _np(t) for n, t in named.items()},
                "moments": {n: {k: {part: mv[k][part].cpu().numpy()
                                    for part in ("q", "scale")}
                                for k in ("m", "v")} for n, mv in mu.items()},
                "local_blocks": blocks, "count": int(state["count"])}
    finally:
        step_mod._int8_leaf_ = real_leaf
        api.clear_overrides()


def int8(rank: int, world: int, outdir: Path, stem: str = "int8") -> None:
    """``tests/test_torch_dist_int8.py``: :func:`int8_runs` on every
    (mesh, FSDP) case of ``<stem>_in.pt``."""
    inp = torch.load(outdir / f"{stem}_in.pt", weights_only=False)
    out = {}
    for mesh_shape, fsdp in inp["cases"]:
        mesh = _mesh(mesh_shape)
        out[("x".join(map(str, mesh_shape)), fsdp)] = int8_runs(inp, mesh,
                                                                fsdp)
    if rank == 0:
        torch.save(out, outdir / f"{stem}_out.pt")


def mesh_cells(rank: int, world: int, outdir: Path) -> None:
    """``tests/test_torch_roofline_mesh.py``: ``dryrun.run_mesh_cell`` on
    (2, 2) for a reduced zamba2-7b ``long_500k`` decode (batch 1, the
    cache cut to 64 positions) and a reduced granite-34b ``train_4k``
    cell, which trains with the reference's int8 moments."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    recs = {}
    for arch, shape_name, over in (("zamba2-7b", "long_500k", {}),
                                   ("granite-34b", "train_4k",
                                    dict(global_batch=4))):
        shape = dataclasses.replace(SHAPES[shape_name], seq_len=64, **over)
        recs[arch] = dryrun.run_mesh_cell(
            arch, shape_name, mesh, outdir / "dryrun",
            cfg=reduce_config(ARCHS[arch], dtype="float32"), shape=shape,
            device="cpu")
    if rank == 0:
        torch.save(recs, outdir / "mesh_cells_out.pt")


def multipod(rank: int, world: int, outdir: Path, *,
             rendezvous: str) -> None:
    """``tests/test_torch_dist_multipod.py`` on the (pod, data, model)
    meshes: :func:`train`'s cases, :func:`decode`'s, :func:`int8`'s, a
    checkpoint saved on (2, 1, 2) and restored onto (2, 2) and onto one
    device, the process groups of the pod mesh; then ``launch.train
    --distributed --multi-pod`` (two steps, then ``--dry-run``) and a
    resume of its checkpoint on the (2, 2) mesh, each a world of its own
    as torchrun would start it."""
    import os
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.launch import train as launch
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        train(rank, world, outdir, stem="multipod")
        decode(rank, world, outdir, stem="multipod_decode")
        int8(rank, world, outdir, stem="multipod_int8")
        res = _pod_checkpoint(rank, world, outdir)
        res["groups"] = _pod_groups(rank, world)
        if rank == 0:
            torch.save(res, outdir / "multipod_misc_out.pt")
    finally:
        dist.destroy_process_group()

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    common = ["--arch", "llama3.2-3b", "--test-mesh", "--device", "cpu",
              "--distributed"]
    out = launch.main(common + ["--multi-pod", "--steps", "2",
                                "--dist-init", f"file://{rendezvous}_pod",
                                "--ckpt-dir", str(outdir / "launch_pod")])
    rec = launch.main(common + ["--multi-pod", "--dry-run",
                                "--dist-init", f"file://{rendezvous}_dry",
                                "--dryrun-dir", str(outdir / "dryrun")])
    # the pod mesh's checkpoint resumed on (2, 2): the run a lost pod's
    # ranks would continue on a mesh of other cards
    resumed = launch.main(common + ["--steps", "3", "--dist-init",
                                    f"file://{rendezvous}_resume",
                                    "--ckpt-dir", str(outdir / "launch_pod")])
    if rank == 0:
        torch.save({"history": out["history"], "dry_run": rec,
                    "resumed": resumed["history"]},
                   outdir / "multipod_launch_out.pt")


def _pod_checkpoint(rank: int, world: int, outdir: Path) -> dict:
    """One AdamW step of ``multipod_ckpt_in.pt``'s config on (2, 1, 2),
    its parameters and moments saved by every rank, then restored onto
    (2, 2) (every rank) and onto one device (rank 0, whole): each side
    gathered whole, and the arrays each rank's shard file holds."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    inp = torch.load(outdir / "multipod_ckpt_in.pt", weights_only=False)
    arch, over = inp["config"]
    cfg = reduce_config(ARCHS[arch], **over)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    shape = ShapeConfig("t", batch["tokens"].shape[1],
                        batch["tokens"].shape[0], "train")

    def gathered(bundle, named, state):
        p_shard, o_shard, _ = bundle.in_shardings
        return {"params": _gather_tree(named, p_shard),
                "m": _gather_tree({n: state["mu"][n]["m"] for n in named},
                                  {n: o_shard["mu"][n]["m"] for n in named}),
                "v": _gather_tree({n: state["mu"][n]["v"] for n in named},
                                  {n: o_shard["mu"][n]["v"] for n in named}),
                "count": int(state["count"])}

    bundle = make_train_step(model, make_optimizer("adamw"), shape,
                             mesh=_mesh((2, 1, 2)))
    params = bundle.shard_params(model.init(0, device="cpu",
                                            trainable=True))
    state = bundle.init_state(params)
    bundle(params, state, batch)
    named = dict(params.named_parameters())
    ckpt = CheckpointManager(str(outdir / "pod_ckpt"), host_id=rank,
                             n_hosts=world)
    ckpt.save(1, (named, state), {"epoch": 0, "index": 8}, blocking=True,
              shardings=bundle.in_shardings[:2])
    res = {"saved": gathered(bundle, named, state)}
    torch.distributed.barrier()

    bundle = make_train_step(model, make_optimizer("adamw"), shape,
                             mesh=_mesh((2, 2)))
    fresh = bundle.shard_params(model.init(7, device="cpu", trainable=True))
    state = bundle.init_state(fresh)
    named = dict(fresh.named_parameters())
    _, ds = CheckpointManager(str(outdir / "pod_ckpt")).restore(
        1, (named, state), shardings=bundle.in_shardings[:2])
    res["restored_2x2"] = gathered(bundle, named, state)
    res["data_state"] = ds
    if rank == 0:
        one = make_train_step(model, make_optimizer("adamw"), shape)
        whole = model.init(7, device="cpu", trainable=True)
        state = one.init_state(whole)
        named = dict(whole.named_parameters())
        CheckpointManager(str(outdir / "pod_ckpt")).restore(
            1, (named, state))
        res["restored_one"] = {
            "params": {n: _np(p) for n, p in named.items()},
            "m": {n: _np(state["mu"][n]["m"]) for n in named},
            "v": {n: _np(state["mu"][n]["v"]) for n in named},
            "count": int(state["count"])}
        step = outdir / "pod_ckpt" / "step_1"
        res["files"] = {h: {k: tuple(a.shape) for k, a in np.load(
            step / f"shard_{h}.npz").items()} for h in range(world)}
    return res


def _pod_groups(rank: int, world: int) -> dict:
    """On (2, 1, 2) and (2, 2, 1): each rank's value summed over ``pod``,
    over the tuple (pod, data) and over (pod, data, model), with the
    group ranks and the axis each collective was recorded under."""
    import torch.distributed as dist
    out = {}
    for shape in ((2, 1, 2), (2, 2, 1)):
        mesh = _mesh(shape)
        x = torch.tensor([float(rank)])
        with C.record_calls() as calls:
            sums = {str(a): float(C.all_reduce(x, a, mesh=mesh))
                    for a in ("pod", ("pod", "data"),
                              ("pod", "data", "model"))}
        group = mesh.group(("pod", "data"))
        found = [None] * world
        dist.all_gather_object(found, {
            "sums": sums, "axes": [c["axis"] for c in calls],
            "group": dist.get_process_group_ranks(group),
            "coords": mesh.coords()})
        out["x".join(map(str, shape))] = found
    return out
