"""Data pipeline, checkpoints, the Trainer's resume and the training
launcher of the port, against the JAX package where it has a counterpart.

The pipeline is a copy of the reference's (pure numpy): the same seeds give
the same batches.  Checkpoints keep the reference's on-disk layout; the
port restores a parameter tree the reference's ``CheckpointManager``
wrote, and a run restarted from its own checkpoint continues bit for bit
(on the CPU) where the uninterrupted run goes.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import \
    CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: E402
                                         reference_tree)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.sharding.rules import NamedSharding  # noqa: E402
from repro_torch.train.trainer import (Trainer, TrainerConfig,  # noqa: E402
                                       quick_train)
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("epoch,index", [(0, 0), (0, 7), (3, 1000)])
def test_synthetic_producer_matches_reference(epoch, index):
    rng = np.random.default_rng(0)
    _same_batch(pipeline.synthetic_lm_producer(1000, 33)(epoch, index, rng),
                jax_pipeline.synthetic_lm_producer(1000, 33)(epoch, index,
                                                             rng))


def test_file_producer_matches_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(5000, dtype=np.int32).tofile(path)
    for i in range(5):
        _same_batch(pipeline.file_lm_producer(str(path), 300, 64)(1, i, None),
                    jax_pipeline.file_lm_producer(str(path), 300, 64)(1, i,
                                                                      None))


def test_batch_queue_matches_reference():
    """The same stream of batches and positions from a restored state."""
    state = dict(epoch=2, index=12)
    port = pipeline.BatchQueue(pipeline.synthetic_lm_producer(500, 16),
                               batch=4, state=pipeline.DataState(**state))
    ref = jax_pipeline.BatchQueue(
        jax_pipeline.synthetic_lm_producer(500, 16), batch=4,
        state=jax_pipeline.DataState(**state))
    try:
        for _ in range(3):
            (pb, ps), (rb, rs) = port.get(), ref.get()
            _same_batch(pb, rb)
            assert ps.as_dict() == rs.as_dict()
    finally:
        port.close()
        ref.close()
    assert pipeline.DataState.from_dict(ps.as_dict()) == ps
    assert pipeline.host_batch_slice(256, 3, 8) == \
        jax_pipeline.host_batch_slice(256, 3, 8)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    g = torch.Generator().manual_seed(0)
    return ({"embed": torch.randn(8, 4, generator=g),
             "blocks.0.ln1": torch.randn(4, generator=g)},
            {"mu": {"embed": {"m": torch.randn(8, 4, generator=g).bfloat16(),
                              "v": torch.rand(8, 4, generator=g)}},
             "count": torch.tensor(3, dtype=torch.int32)})


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_round_trip_and_layout(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, {"epoch": 0, "index": 40})
    mgr.wait()
    cdir = tmp_path / "step_5"
    assert sorted(p.name for p in cdir.iterdir()) == \
        ["data_state.json", "manifest.json", "shard_0.npz"]
    manifest = json.loads((cdir / "manifest.json").read_text())
    assert manifest["step"] == 5 and manifest["n_hosts"] == 1
    names = {m["name"]: m["dtype"] for m in manifest["leaves"]}
    assert names["[1]['mu']['embed']['m']"] == "bfloat16"
    assert names["[0]['embed']"] == "float32"
    target = _zeros_like(tree)
    got, ds = mgr.restore(5, target)
    assert got is target and ds == {"epoch": 0, "index": 40}
    _equal(target, tree)


def test_garbage_collection_keeps_the_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4


def test_atomic_publish(tmp_path):
    """A save in flight lives in ``step_<n>.tmp`` until it is renamed; a
    half-written directory is never listed."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "shard_0.npz").write_bytes(b"partial")
    (tmp_path / "step_8").mkdir()          # no manifest: not published
    assert mgr.latest_step() is None
    mgr.save(2, _tree(), blocking=True)
    assert mgr.all_steps() == [2]
    assert not (tmp_path / "step_2.tmp").exists()


class _MeshAt(Mesh):
    """An abstract mesh seen from the rank at ``coords``."""

    def __init__(self, shape, axes, coords):
        super().__init__(shape, axes)
        self._at = dict(coords)

    def coords(self):
        return dict(self._at)


def _shardings(mesh):
    """The placements of ``_tree()`` on a ("data",) mesh: the table's rows
    and its moments split over data, the rest replicated."""
    rows, whole = NamedSharding(mesh, ("data",)), NamedSharding(mesh, ())
    return ({"embed": rows, "blocks.0.ln1": whole},
            {"mu": {"embed": {"m": rows, "v": rows}}, "count": whole})


@pytest.mark.parametrize("host", [0, 1])
def test_multi_host_checkpoint_restores_onto_a_mesh(tmp_path, host):
    """Two hosts of a ("data",) mesh of 2 each write their block of the
    rows (host 0 publishes once both files are in); the checkpoint reads
    back whole on one device and re-shards onto either host's block."""
    full = _tree()
    for h in (1, 0):
        mesh = _MeshAt((2,), ("data",), {"data": h})
        sh = _shardings(mesh)
        local = _map2(lambda t, s: s.shard(t).clone(), full, sh)
        CheckpointManager(str(tmp_path), host_id=h, n_hosts=2).save(
            4, local, {"epoch": 0, "index": 2}, blocking=True, shardings=sh)
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    assert manifest["n_hosts"] == 2 and manifest["mesh"] == {
        "axes": ["data"], "shape": [2]}
    embed = next(m for m in manifest["leaves"] if m["name"] == "[0]['embed']")
    assert embed["global_shape"] == [8, 4] and embed["shard_shape"] == [4, 4]
    whole = _zeros_like(full)
    CheckpointManager(str(tmp_path)).restore(4, whole)
    _equal(whole, full)
    sh = _shardings(_MeshAt((2,), ("data",), {"data": host}))
    target = _map2(lambda t, s: torch.zeros_like(s.shard(t)), full, sh)
    _, ds = CheckpointManager(str(tmp_path)).restore(4, target, shardings=sh)
    _equal(target, _map2(lambda t, s: s.shard(t), full, sh))
    assert ds == {"epoch": 0, "index": 2}


def test_restore_holds_one_leaf_at_a_time(tmp_path):
    """A re-sharding restore builds one global leaf on the host at a time:
    its peak of host allocations stays under three leaves' bytes for a
    checkpoint of eight, written by two hosts and read back onto one
    host's block."""
    import tracemalloc
    g = torch.Generator().manual_seed(1)
    full = {f"w{i}": torch.randn(256, 1024, generator=g) for i in range(8)}
    leaf_bytes = 256 * 1024 * 4
    for h in (1, 0):
        rows = NamedSharding(_MeshAt((2,), ("data",), {"data": h}),
                             ("data",))
        CheckpointManager(str(tmp_path), host_id=h, n_hosts=2).save(
            1, {k: rows.shard(v).clone() for k, v in full.items()},
            blocking=True, shardings={k: rows for k in full})
    rows = NamedSharding(_MeshAt((2,), ("data",), {"data": 1}), ("data",))
    target = {k: torch.zeros(128, 1024) for k in full}
    tracemalloc.start()
    try:
        CheckpointManager(str(tmp_path)).restore(
            1, target, shardings={k: rows for k in full})
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    for k, v in full.items():
        assert torch.equal(target[k], rows.shard(v))
    assert peak < 3 * leaf_bytes, (peak, leaf_bytes)


def test_unpublished_multi_host_save_raises(tmp_path, monkeypatch):
    """Host 0 publishes only once every rank's shard is in: a rank that
    never writes makes its save fail, raised by ``wait``, and nothing is
    listed."""
    from repro_torch.checkpoint import ckpt as ckpt_mod
    monkeypatch.setattr(ckpt_mod, "PUBLISH_TIMEOUT_S", 0.2)
    mgr = CheckpointManager(str(tmp_path), host_id=0, n_hosts=2)
    with pytest.raises(TimeoutError, match="shard"):
        mgr.save(1, _tree(), blocking=True)
    assert mgr.all_steps() == []
    mgr.wait()                              # the error is raised once


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _reference_pair(arch="llama3.2-3b", **kw):
    jcfg = jax_reduce(JAX_ARCHS[arch], n_layers=2, **kw)
    tcfg = reduce_config(ARCHS[arch], n_layers=2, **kw)
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    return tcfg, jp


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_restores_a_checkpoint_the_reference_wrote(tmp_path, arch):
    """The reference's ``CheckpointManager`` saves (params, AdamW state);
    the port reads the directory and builds the same model and the same
    optimizer state as from the reference's trees directly."""
    tcfg, jp = _reference_pair(arch)
    jopt = jax_make_optimizer("adamw")
    jstate = jopt.init(jp)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.1, jp)
    jp, jstate = jopt.update(grads, jstate, jp)
    JaxCheckpointManager(str(tmp_path)).save(7, (jp, jstate),
                                             {"epoch": 0, "index": 3},
                                             blocking=True)
    leaves, ds = CheckpointManager(str(tmp_path)).read(7)
    assert ds == {"epoch": 0, "index": 3}
    got = params_from_numpy(reference_tree(leaves, 0), tcfg, "cpu",
                            trainable=True)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                             "cpu", trainable=True)
    _equal(dict(got.named_parameters()), dict(want.named_parameters()))
    got_s = adamw_state_from_numpy(reference_tree(leaves, 1), tcfg, "cpu")
    want_s = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, "cpu")
    _equal(got_s, want_s)
    assert int(got_s["count"]) == 1


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_state_from_numpy(state_dtype):
    """The reference's AdamW state after a step, carried into the port:
    each layer's moments are the reference's stacked moments' slices (int8
    blocks split between layers), and one more update of each from the
    same grads agrees."""
    kw = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=512)
    tcfg, jp = _reference_pair(**kw)
    jopt = jax_make_optimizer("adamw", state_dtype=state_dtype)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.sin(jnp.arange(p.size, dtype=jnp.float32)
                          ).reshape(p.shape) * 1e-2, jp)
    jp1, jstate = jopt.update(grads, jopt.init(jp), jp)
    jp2, _ = jopt.update(grads, jstate, jp1)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp1), tcfg,
                               "cpu", trainable=True)
    state = adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   tcfg, "cpu")
    tgrads = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads),
                               tcfg, "cpu", trainable=True)
    named = dict(params.named_parameters())
    opt = make_optimizer("adamw", state_dtype=state_dtype)
    opt.update_({n: p.detach() for n, p in tgrads.named_parameters()},
                state, named)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp2), tcfg,
                             "cpu", trainable=True)
    for n, p in want.named_parameters():
        np.testing.assert_allclose(named[n].detach().numpy(),
                                   p.detach().numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    assert int(state["count"]) == 2


def test_int8_state_that_does_not_split_raises():
    tcfg, jp = _reference_pair()                 # d 64: not whole blocks
    jopt = jax_make_optimizer("adamw", state_dtype="int8")
    state = jax.tree_util.tree_map(np.asarray, jopt.init(jp))
    with pytest.raises(ValueError, match="whole number"):
        adamw_state_from_numpy(state, tcfg, "cpu")


# ---------------------------------------------------------------------------
# trainer and launcher
# ---------------------------------------------------------------------------

def _trainer(cfg, steps, ckpt_dir):
    shape = ShapeConfig("t", 32, 4, "train")
    return Trainer(build_model(cfg), make_optimizer("adamw"), shape,
                   TrainerConfig(steps=steps, log_every=1, ckpt_every=2,
                                 ckpt_dir=ckpt_dir),
                   microbatches=2, device="cpu")


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """4 steps straight against 2 steps, a checkpoint and a restart: steps
    3-4 give the same losses and the same final parameters, bit for bit,
    and the restored data state is the saved one."""
    cfg = reduce_config(ARCHS["llama3.2-3b"], n_layers=2,
                        attention_impl="pallas", block_q=16, block_kv=16,
                        remat=True)
    straight = _trainer(cfg, 4, None).run()
    first = _trainer(cfg, 2, str(tmp_path)).run()
    saved = json.loads((tmp_path / "step_2" / "data_state.json").read_text())
    trainer = _trainer(cfg, 4, str(tmp_path))
    resumed = trainer.run()
    losses = [h["loss"] for h in straight["history"]]
    assert [h["loss"] for h in first["history"]] == losses[:2]
    assert [h["loss"] for h in resumed["history"]] == losses[2:]
    assert trainer.restored_data_state.as_dict() == saved == \
        {"epoch": 0, "index": 8}
    want = dict(straight["params"].named_parameters())
    for n, p in resumed["params"].named_parameters():
        assert torch.equal(p, want[n]), n
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_launch_train_test_mesh_on_the_cpu(capsys):
    out = launch_train.main(["--arch", "llama3.2-3b", "--test-mesh",
                             "--device", "cpu", "--steps", "2"])
    assert np.isfinite(out["final_loss"]) and len(out["history"]) == 2
    assert "final loss" in capsys.readouterr().out
    assert out["memory_plan"]["source"] == "model"
    assert "remat_saved" not in out["memory_plan"]   # reduced: remat off


# --dry-run runs the cost probe on one card (tests/test_torch_probe.py);
# --multi-pod, with or without --dry-run, trains on (or dry-runs) a pod
# mesh, which needs a world of ranks: without --distributed it raises
# (with it: tests/test_torch_dist_multipod.py, and the two cases below).
# --distributed trains on the world's mesh
# (test_launch_train_distributed_on_four_cpu_ranks); without a card it
# runs only when asked for the CPU (gloo), and refuses otherwise
POD_FLAGS = {"--dry-run": (["--dry-run", "--multi-pod"], "cpu",
                           ValueError, "needs a world of ranks"),
             "--multi-pod": (["--multi-pod"], "cpu", ValueError,
                             "needs a world of ranks"),
             "--distributed": (["--distributed"], None, RuntimeError,
                               "no CUDA device")}


@pytest.mark.parametrize("flag", list(POD_FLAGS))
def test_launch_train_pod_flags_raise(flag):
    argv, device, exc, match = POD_FLAGS[flag]
    if device is None and torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    with pytest.raises(exc, match=match):
        launch_train.main(["--arch", "llama3.2-3b", "--test-mesh",
                           "--steps", "1", *argv]
                          + (["--device", device] if device else []))


# --multi-pod --distributed on a world of one rank: the pod axis of 2
# does not divide it, so the mesh refuses; on a world of two it trains on
# (2, 1, 1), and --dry-run writes the multipod record
POD_RUNS = {"one rank": (1, [], "does not divide 1"),
            "two ranks": (2, [], None),
            "two ranks, --dry-run": (2, ["--dry-run"], None)}


@pytest.mark.parametrize("case", list(POD_RUNS))
def test_launch_train_multi_pod_with_a_world(tmp_path, case):
    world, extra, refusal = POD_RUNS[case]
    run_ranks("launch_multi_pod", tmp_path, world=world, join=False,
              timeout=180, extra=extra, refusal=refusal)
    out = torch.load(tmp_path / "launch_multi_pod_out.pt",
                     weights_only=False)
    if refusal is not None:
        assert refusal in out["refused"]
        return
    if extra:
        rec = json.loads((tmp_path / "dryrun" /
                          "llama3.2-3b__train_4k__2x1x1.json").read_text())
        assert (rec["mesh"], rec["chips"], rec["status"]) == \
            ("multipod", 2, "ok")
        assert set(rec["collectives"]["per_axis"]) == {"pod"}
        return
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launch_train_distributed_on_four_cpu_ranks(tmp_path):
    """``launch.train --distributed --test-mesh --device cpu`` on 4 ranks
    (each joins the world itself, as under torchrun): two steps on the
    (2, 2) test mesh, the loss falls, and the sharded checkpoint of the
    last step is published; with ``--dry-run`` the mesh cell's record
    holds one step's collectives by kind; with ``--optimizer adamw_int8
    --batch 1`` two steps run."""
    run_ranks("launch_train", tmp_path, join=False, timeout=240)
    out = torch.load(tmp_path / "launch_out.pt", weights_only=False)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    manifest = json.loads((tmp_path / "ckpt" / "step_2" /
                           "manifest.json").read_text())
    assert manifest["n_hosts"] == 4
    assert manifest["mesh"] == {"axes": ["data", "model"], "shape": [2, 2]}
    rec = json.loads((tmp_path / "dryrun" /
                      "llama3.2-3b__train_4k__2x2.json").read_text())
    assert rec == out["dry_run"] and rec["status"] == "ok"
    per_op = rec["collectives"]["per_op"]
    assert per_op["all-reduce"]["count"] > 0 and \
        per_op["all-gather"]["count"] > 0
    assert rec["collectives"]["collective_bytes"] > 0
    # ``--optimizer adamw_int8 --batch 1``: int8 moments on the mesh, a
    # batch every rank takes whole (a new sequence each step)
    losses = [h["loss"] for h in out["int8_history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launch_train_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "llama3.2-3b", "--test-mesh",
                           "--steps", "1"])


def test_quick_train_learns():
    cfg = dataclasses.replace(reduce_config(ARCHS["llama3.2-3b"]),
                              n_layers=1)
    out = quick_train(cfg, steps=6, seq_len=16, global_batch=4,
                      device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 6 and losses[-1] < losses[0]
