"""The reference's multi-pod path on the port: the (pod, data, model) mesh
on 4 gloo ranks against the JAX reference's one-device functions, its
process groups, checkpoints, launcher, dry-run record and pod-axis probe,
and ``examples/torch_distributed_pretrain.py``.

The pod axis is the reference's plain data parallelism: the batch splits
over (pod, data), the parameters are replicated over ``pod``, and a
gradient block is all-reduced over it after the ``data`` reduction.  The
meshes are the reference's (2, 16, 16) at four ranks: (2, 1, 2), where
``model`` still splits the heads, mlp columns, experts and vocabulary,
and (2, 2, 1), where ``data`` carries the ZeRO-1 and FSDP cuts.

* Train: a reduced llama (2 layers, d 64, 4 heads of 16, kv heads 2,
  vocab 512) and granite-moe (2 layers, 4 experts top 2; its expert FFN
  in the reference computes the fused SwiGLU kernel's function,
  ``_KernelFFN``, as ``tests/test_torch_dist_families.py``'s), fp32,
  ``block_q`` 32 against a sequence of 48 (the flash path), on both
  meshes with FSDP forced on and off at 1 and 2 micro-batches: the loss,
  the gradient norm and every gradient leaf equal the reference's
  ``jax.value_and_grad`` (the mean over the micro-batches' rows for the
  MoE) to 1e-4 elementwise, the first moments (1 - b1) g, and the
  parameters after one AdamW step equal the one-rank port's where the
  gradient is at least 1e-6.  The reference's own mesh tests fail on jax
  0.9.0, so the port is held to its one-device functions.
* Prefill on both meshes: the logits (each rank's rows over (pod, data),
  its vocabulary columns) equal the reference's forward to 1e-4.
* Decode on both meshes: 10 steps of 4 sequences (2 or 1 a batch rank)
  of the llama and granite configs from a zero state against the
  reference's jitted ``decode_fn``, logits and final state to 1e-4.
* int8 moments on (2, 2, 1): 2 steps; the reference's int8 AdamW of the
  mesh's own gradients reproduces the parameters (1e-6), ``scale``
  (1e-6) and ``q`` (within one step), the port's one-rank optimizer so
  fed bit for bit, and each rank holds its blocks over (data, model)
  only: the moments' blocks are not cut over ``pod``.
* A checkpoint saved on (2, 1, 2) writes every block once (the pod
  replicas' files hold nothing) and restores onto (2, 2) and onto one
  device bit for bit.
* ``launch.train --distributed --multi-pod`` trains two steps on (2, 1, 2),
  its ``--dry-run`` record is named
  ``<arch>__<shape>__2x1x2.json`` and marked ``multipod``, and its
  checkpoint resumes on (2, 2).
* ``tools/torch_multipod_probe.py`` on the reduced llama: ``pod_axis_bytes``
  is the multi-pod record's all-reduce bytes over ``pod`` and the
  reckoning from the placements.

All ranks run in one child process under a hard limit
(``tests/torch_dist_util.py``); the reference's runs are compiled in a
thread beside them.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_leaf_paths, params_from_numpy  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_pod_mesh  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from torch_dist_cases import int8_runs  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.xdist_group("dist_multipod")

ROOT = Path(__file__).resolve().parent.parent
B, S = 8, 48
FLASH = dict(dtype="float32", attention_impl="pallas", block_q=32,
             block_kv=32)
CONFIGS = {
    "llama": ("llama3.2-3b", dict(FLASH, n_layers=2, d_model=64, n_heads=4,
                                  n_kv_heads=2, head_dim=16, vocab=512)),
    "granite": ("granite-moe-1b-a400m", dict(FLASH, n_layers=2)),
}
MESHES = [(2, 1, 2), (2, 2, 1)]
MKEYS = ["x".join(map(str, m)) for m in MESHES]
TRAIN = [(m, c, f, mb) for m in MKEYS for c in CONFIGS
         for f in (False, True) for mb in (1, 2)]
LR = 1e-2
DECODE_B, DECODE_LEN, DECODE_STEPS = 4, 16, 10
DECODE = {"llama": ("llama3.2-3b", dict(dtype="float32")),
          "granite": ("granite-moe-1b-a400m",
                      dict(dtype="float32", n_layers=2))}
INT8 = {"config": ("llama3.2-3b", dict(dtype="float32")),
        "lr": 3e-4, "steps": 2, "cases": [((2, 2, 1), None)]}


class _KernelFFN:
    """``jax.numpy`` as the reference's ``models/moe.py`` sees it, its
    expert FFN the fused SwiGLU kernel's function (fp32 gate and up,
    the hidden rounded once)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, a, b, **kw):
        if spec == "gecd,edf->gecf":
            return jnp.einsum(spec, a.astype(jnp.float32),
                              b.astype(jnp.float32), **kw)
        if spec == "gecf,efd->gecd":
            return jnp.einsum(spec, a.astype(b.dtype), b, **kw)
        return jnp.einsum(spec, a, b, **kw)


@pytest.fixture(scope="module", autouse=True)
def reference_experts_are_the_kernels_function():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_moe, "jnp", _KernelFFN())
        yield


def _cfgs(name):
    arch, over = CONFIGS[name]
    return arch, over, jax_reduce(JAX_ARCHS[arch],
                                  **dict(over, attention_impl="naive"))


@functools.lru_cache(maxsize=None)
def _tree(name):
    _, _, jcfg = _cfgs(name)
    return jax.tree_util.tree_map(np.asarray,
                                  jax_build(jcfg).init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _batch(name):
    _, _, jcfg = _cfgs(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _leaf(tree, path, i):
    for k in path:
        tree = tree[k]
    return np.asarray(tree if i is None else tree[i], np.float32)


def _reference(name, mb=1):
    """(loss, grads by port name) of the reference: the mean of
    ``value_and_grad(loss_fn)`` over ``mb`` row blocks of the batch for
    the MoE (its auxiliary loss is a product of means over a
    micro-batch), over the batch for the others."""
    return _reference_run(name, mb if _cfgs(name)[2].is_moe else 1)


@functools.lru_cache(maxsize=None)
def _reference_run(name, mb):
    arch, over, jcfg = _cfgs(name)
    model = jax_build(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(name))
    batch = {k: jnp.asarray(v) for k, v in _batch(name).items()}
    fn = jax.jit(jax.value_and_grad(model.loss_fn))
    losses, grads = [], []
    for i in range(mb):
        loss, g = fn(params, {k: v[i * B // mb:(i + 1) * B // mb]
                              for k, v in batch.items()})
        losses.append(float(loss))
        grads.append(g)
    tcfg = reduce_config(ARCHS[arch], **over)
    return float(np.mean(losses)), {
        n: np.mean([_leaf(g, path, i) for g in grads], axis=0)
        for n, path, i in lm_leaf_paths(tcfg, grads[0])}


@functools.lru_cache(maxsize=None)
def _one_rank(name, mb):
    """The port's parameters after one AdamW step on one rank."""
    arch, over, _ = _cfgs(name)
    cfg = reduce_config(ARCHS[arch], **over)
    bundle = make_train_step(build_model(cfg),
                             make_optimizer("adamw", lr=LR),
                             ShapeConfig("t", S, B, "train"),
                             microbatches=mb)
    params = params_from_numpy(_tree(name), cfg, "cpu", trainable=True)
    bundle(params, bundle.init_state(params),
           {k: torch.from_numpy(v) for k, v in _batch(name).items()})
    return {n: p.detach().numpy().copy()
            for n, p in params.named_parameters()}


def _decode_jcfg(name):
    arch, over = DECODE[name]
    return jax_reduce(JAX_ARCHS[arch], **over)


@functools.lru_cache(maxsize=None)
def _decode_tree(name):
    return jax.tree_util.tree_map(
        np.asarray, jax_build(_decode_jcfg(name)).init(
            jax.random.PRNGKey(0)))


def _decode_tokens(name):
    rng = np.random.default_rng(3)
    return rng.integers(0, _decode_jcfg(name).vocab,
                        (DECODE_STEPS, DECODE_B)).astype(np.int32)


def _decode_lens():
    return [(t + np.arange(DECODE_B)).astype(np.int32)
            for t in range(DECODE_STEPS)]


@functools.lru_cache(maxsize=None)
def _decode_reference(name):
    """(logits (STEPS, B, V), final state) of the reference's jitted
    ``decode_fn`` from a zero state."""
    model = jax_build(_decode_jcfg(name))
    params = jax.tree_util.tree_map(jnp.asarray, _decode_tree(name))
    state = model.decode_init(DECODE_B, DECODE_LEN)
    step = jax.jit(model.decode_fn)
    logits = []
    for tok, lens in zip(_decode_tokens(name), _decode_lens()):
        lg, state = step(params, state, jnp.asarray(tok), jnp.asarray(lens))
        logits.append(np.asarray(lg, np.float32))
    return np.stack(logits), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), state)


def _int8_inputs():
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (4, 16)).astype(np.int64)
    return {**INT8, "batch": {"tokens": tokens,
                              "targets": np.roll(tokens, -1, axis=1)}}


def _int8_reference(inp, grads):
    """The reference's int8 AdamW from the port's initial parameters over
    ``grads``, a step's whole gradients each: (parameters, moments)."""
    arch, over = inp["config"]
    model = build_model(reduce_config(ARCHS[arch], **over))
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in
              model.init(0, device="cpu", trainable=True).named_parameters()}
    opt = jax_opt.make_optimizer("adamw", state_dtype="int8", lr=inp["lr"])
    state = opt.init(params)
    for g in grads:
        params, state = opt.update({n: jnp.asarray(v) for n, v in g.items()},
                                   state, params)
    return jax.tree_util.tree_map(np.asarray, (params, state["mu"]))


def _references():
    for name in CONFIGS:
        for mb in (1, 2):
            _reference(name, mb)
        _reference_logits(name)
    for name in DECODE:
        _decode_reference(name)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_multipod")
    cases = [{"config": c, "fsdp": f, "mb": mb, "kind": "train",
              "mesh": m} for m, c, f, mb in TRAIN]
    cases += [{"config": c, "fsdp": False, "mb": 1, "kind": "prefill",
               "mesh": m} for m in MKEYS for c in CONFIGS]
    torch.save({"configs": {n: _cfgs(n)[:2] for n in CONFIGS},
                "trees": {n: _tree(n) for n in CONFIGS},
                "batches": {n: _batch(n) for n in CONFIGS},
                "meshes": MESHES, "cases": cases}, out / "multipod_in.pt")
    torch.save({"configs": DECODE,
                "trees": {n: _decode_tree(n) for n in DECODE},
                "tokens": {n: _decode_tokens(n) for n in DECODE},
                "cross": {}, "lens": _decode_lens(), "batch": DECODE_B,
                "max_seq": DECODE_LEN, "meshes": MESHES},
               out / "multipod_decode_in.pt")
    int8_in = _int8_inputs()
    torch.save(int8_in, out / "multipod_int8_in.pt")
    torch.save({"config": ("llama3.2-3b", dict(dtype="float32")),
                "batch": int8_in["batch"]}, out / "multipod_ckpt_in.pt")
    warm = threading.Thread(target=_references)
    warm.start()
    try:
        run_ranks("multipod", out, timeout=500, join=False)
    finally:
        warm.join()
    load = functools.partial(torch.load, weights_only=False)
    int8 = load(out / "multipod_int8_out.pt")
    return {"train": load(out / "multipod_out.pt"),
            "decode": load(out / "multipod_decode_out.pt"),
            "int8": int8,
            "int8_replay": {k: int8_runs(int8_in, grads=g["grads"])
                            for k, g in int8.items()},
            "int8_in": int8_in,
            "misc": load(out / "multipod_misc_out.pt"),
            "launch": load(out / "multipod_launch_out.pt"), "dir": out}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mkey,name,fsdp,mb", TRAIN)
def test_pod_step_equals_the_reference(results, mkey, name, fsdp, mb):
    got = results["train"][(mkey, name, fsdp, mb)]
    loss, grads = _reference(name, mb)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-4, atol=1e-4)
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4,
                                   atol=1e-4, err_msg=n)
        # the first moment is (1 - b1) g: the ZeRO-1 blocks line up
        np.testing.assert_allclose(got["moments"][n], 0.1 * g,
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in grads.values()))
    np.testing.assert_allclose(got["grad_norm"], norm, rtol=1e-4)
    after = _one_rank(name, mb)
    for n, p in after.items():
        keep = np.abs(grads[n]) >= 1e-6
        np.testing.assert_allclose(got["params"][n][keep], p[keep],
                                   rtol=1e-5, atol=1e-5, err_msg=n)


@functools.lru_cache(maxsize=None)
def _reference_logits(name):
    _, _, jcfg = _cfgs(name)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(name))
    logits = jax.jit(jax_build(jcfg).forward)(
        params, {k: jnp.asarray(v) for k, v in _batch(name).items()})
    return np.asarray(logits[0] if isinstance(logits, tuple) else logits,
                      np.float32)


@pytest.mark.parametrize("mkey", MKEYS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_pod_prefill_logits_equal_the_reference(results, mkey, name):
    """Each rank's rows of the batch (over (pod, data)) and its vocabulary
    columns, gathered by the step's out placement."""
    np.testing.assert_allclose(results["train"][(mkey, name, "prefill")],
                               _reference_logits(name), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mkey", MKEYS)
@pytest.mark.parametrize("name", list(DECODE))
def test_pod_decode_equals_the_reference(results, mkey, name):
    got = results["decode"][(mkey, name)]
    logits, state = _decode_reference(name)
    np.testing.assert_allclose(got["logits"], logits, rtol=1e-4, atol=1e-4)
    flat = jax.tree_util.tree_leaves_with_path(state)
    assert flat
    for path, want in flat:
        leaf = got["state"]
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# int8 moments on (2, 2, 1)
# ---------------------------------------------------------------------------

INT8_KEY = ("2x2x1", None)


def test_pod_int8_step_is_the_reference_update_of_its_gradients(results):
    got = results["int8"][INT8_KEY]
    params, mu = _int8_reference(results["int8_in"], got["grads"])
    assert set(params) == set(got["params"])
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n], p, rtol=0, atol=1e-6,
                                   err_msg=n)
        for k in ("m", "v"):
            a, b = got["moments"][n][k], mu[n][k]
            assert a["q"].shape == b["q"].shape, (n, k)
            dq = np.abs(a["q"].astype(np.int32) - b["q"].astype(np.int32))
            assert dq.max() <= 1, (n, k)
            np.testing.assert_allclose(a["scale"], b["scale"], rtol=1e-6,
                                       err_msg=f"{n}.{k}")


def test_pod_int8_step_is_the_one_rank_update_of_its_gradients(results):
    got, replay = results["int8"][INT8_KEY], results["int8_replay"][INT8_KEY]
    assert got["count"] == replay["count"] == 2
    for n, p in replay["params"].items():
        np.testing.assert_array_equal(got["params"][n], p, err_msg=n)
        for k in ("m", "v"):
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    got["moments"][n][k][part], replay["moments"][n][k][part],
                    err_msg=f"{n}.{k}.{part}")


def test_pod_int8_blocks_are_not_cut_over_pod(results):
    """On (2, 2, 1) a leaf of nb blocks, nb even, holds nb / 2 a rank (the
    blocks go over (data, model) = 2 ranks; both pods hold the same),
    the others all of them."""
    got = results["int8"][INT8_KEY]
    for n, whole in got["moments"].items():
        nb = whole["m"]["q"].shape[0]
        want = nb // 2 if nb % 2 == 0 else nb
        assert got["local_blocks"][n] == (want, 256), n


# ---------------------------------------------------------------------------
# checkpoints, process groups
# ---------------------------------------------------------------------------

def _equal_trees(a, b):
    for part in ("params", "m", "v"):
        assert set(a[part]) == set(b[part])
        for n in a[part]:
            np.testing.assert_array_equal(a[part][n], b[part][n],
                                          err_msg=f"{part} {n}")
    assert a["count"] == b["count"] == 1


@pytest.mark.parametrize("onto", ["restored_2x2", "restored_one"])
def test_pod_checkpoint_restores_bit_for_bit(results, onto):
    misc = results["misc"]
    _equal_trees(misc[onto], misc["saved"])
    assert misc["data_state"] == {"epoch": 0, "index": 8}


def test_pod_checkpoint_writes_each_block_once(results):
    """On (2, 1, 2) the ranks of pod 1 (ranks 2 and 3) hold replicas of
    pod 0's blocks and write nothing; of the blocks every model rank
    holds whole (norm scales, attention weights), rank 0 writes the one
    copy, and the files hold as many elements as the global leaves."""
    misc = results["misc"]
    files = misc["files"]
    assert files[2] == {} and files[3] == {}
    assert set(files[1]) < set(files[0])
    saved = sum(np.asarray(misc["saved"][part][n]).size
                for part in ("params", "m", "v") for n in misc["saved"][part])
    written = sum(int(np.prod(s)) for f in files.values()
                  for k, s in f.items() if k != "[1]['count']")
    assert written == saved


@pytest.mark.parametrize("mkey", MKEYS)
def test_pod_mesh_groups(results, mkey):
    """A tuple of axes is one collective: (pod, data) on (2, 1, 2) over
    the pod line (its one wide axis), on (2, 2, 1) over the world; each
    is recorded under its wide axes."""
    found = results["misc"]["groups"][mkey]
    shape = tuple(map(int, mkey.split("x")))
    for r, f in enumerate(found):
        c = f["coords"]
        pod_line = [q for q, g in enumerate(found)
                    if all(g["coords"][a] == c[a] for a in ("data", "model"))]
        assert f["sums"]["pod"] == float(sum(pod_line))
        pd_line = [q for q, g in enumerate(found)
                   if g["coords"]["model"] == c["model"]]
        assert f["group"] == pd_line
        assert f["sums"][str(("pod", "data"))] == float(sum(pd_line))
        assert f["sums"][str(("pod", "data", "model"))] == 6.0
    axes = found[0]["axes"]
    assert axes[0] == "pod"
    assert axes[1] == ("pod" if shape[1] == 1 else ("pod", "data"))


@pytest.mark.parametrize("pair", [("pod", "data"), ("pod", "model"),
                                  ("data", "model")])
def test_no_group_over_axes_that_leave_out_a_wide_axis(pair):
    """On (2, 2, 2) every pair of axes leaves out a wide one: the mesh
    builds no group for it (``all_reduce`` runs one collective an axis
    there) and says so."""
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"), device_mesh=object())
    assert mesh.wide(pair) == pair
    with pytest.raises(ValueError, match="spans the mesh"):
        mesh.group(pair)


def test_make_pod_mesh_refuses_a_world_it_does_not_divide():
    with pytest.raises(ValueError, match="does not divide 6"):
        make_pod_mesh(6, model=2, device="cpu")


# ---------------------------------------------------------------------------
# the launcher, the dry run, the probe
# ---------------------------------------------------------------------------

def test_launch_train_multi_pod_trains(results):
    """Four ranks, ``--multi-pod``: two steps on (2, 1, 2), the loss
    falls, and the checkpoint records the pod mesh."""
    losses = [h["loss"] for h in results["launch"]["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[1] < losses[0]
    manifest = json.loads((results["dir"] / "launch_pod" / "step_2" /
                           "manifest.json").read_text())
    assert manifest["mesh"] == {"axes": ["pod", "data", "model"],
                                "shape": [2, 1, 2]}


def test_pod_checkpoint_resumes_on_the_data_model_mesh(results):
    """The (2, 1, 2) run's step-2 checkpoint, resumed by ``launch.train
    --distributed`` on (2, 2): only step 2 runs."""
    resumed = results["launch"]["resumed"]
    assert [h["step"] for h in resumed] == [2]
    assert np.isfinite(resumed[0]["loss"])


def test_multi_pod_dry_run_record(results):
    rec = json.loads((results["dir"] / "dryrun" /
                      "llama3.2-3b__train_4k__2x1x2.json").read_text())
    assert rec == json.loads(json.dumps(results["launch"]["dry_run"]))
    assert (rec["mesh"], rec["mesh_shape"], rec["chips"]) == \
        ("multipod", "2x1x2", 4)
    assert rec["axes"] == ["pod", "data", "model"]
    per_axis = rec["collectives"]["per_axis"]
    assert set(per_axis) == {"pod", "model"}
    assert set(per_axis["pod"]) == {"all-reduce"}


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    out = tmp_path_factory.mktemp("multipod_probe")
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_multipod_probe.py"),
         "llama3.2-3b", "--device", "cpu", "--test-mesh", "--out",
         str(out)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-4000:]
    return out


def test_probe_pod_axis_bytes_are_the_pod_all_reduce(probe):
    """The difference of the two steps' collective bytes is exactly the
    multi-pod step's all-reduce bytes over ``pod`` (each batch rank takes
    one sequence in both, so the model axis moves the same), and the
    reckoning from the placements: every gradient block and two
    scalars."""
    entry = json.loads((probe / "multipod_pod_axis.json").read_text())[
        "llama3.2-3b"]
    assert entry["status"] == "ok"
    multi = json.loads((probe / entry["records"][1]).read_text())
    single = json.loads((probe / entry["records"][0]).read_text())
    assert (multi["mesh"], single["mesh"]) == ("multipod", "1x2")
    pod = multi["collectives"]["per_axis"]["pod"]
    assert set(pod) == {"all-reduce"}
    assert entry["pod_axis_bytes"] == pod["all-reduce"]["operand_bytes"] \
        == entry["reckoned_pod_axis_bytes"] > 0
    assert multi["collectives"]["per_axis"]["model"] == \
        single["collectives"]["per_axis"]["model"]
    for key in ("coll_singlepod", "coll_multipod", "t_nvlink_s",
                "t_nvlink_ef_int8_s", "t_nvlink_singlepod_s"):
        assert key in entry
    assert entry["t_nvlink_s"] == pytest.approx(
        entry["pod_axis_bytes"] / entry["link_bytes_per_s"])
    assert entry["t_nvlink_ef_int8_s"] == pytest.approx(
        entry["t_nvlink_s"] / 4)
    assert not any("dcn" in k for k in entry)


def test_probe_marks_an_arch_beyond_the_card(probe):
    """qwen3-moe-235b-a22b at full size: its parameters, gradients and
    int8 moments a rank are reckoned from the placements, exceed the
    card's 80 GB, and no rank runs."""
    spec = importlib.util.spec_from_file_location(
        "torch_multipod_probe", ROOT / "tools" / "torch_multipod_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    entry = mod.probe("qwen3-moe-235b-a22b",
                      type("A", (), {"test_mesh": False, "out": str(probe)}),
                      False, 80e9)
    assert entry["status"] == "does_not_fit"
    assert entry["reckoned_bytes_per_rank"] > 80e9


def test_roofline_prints_the_pod_tables_apart(probe, capsys):
    roofline.main(["--results", str(probe), "--table", "dryrun"])
    text = capsys.readouterr().out
    single, multi = text.split("### multi-pod")
    assert "ok 1x2" in single and "2x1x2" not in single
    assert "ok 2x1x2" in multi and "ok 1x2" not in multi


# ---------------------------------------------------------------------------
# examples/torch_distributed_pretrain.py
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_on_a_world_of_one(tmp_path):
    """Twelve steps of 2 x 16 tokens on the CPU: the example's own check
    that the loss fell passes, the losses are finite, a checkpoint of a
    (1, 1) mesh is published and a heartbeat written."""
    ex = _example("torch_distributed_pretrain")
    out = ex.main(["--steps", "12", "--seq-len", "16", "--batch", "2",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    assert np.isfinite(out["first"]) and np.isfinite(out["final_loss"])
    assert out["n_params"] == ex.make_100m_config().param_count()
    manifest = json.loads((tmp_path / "step_12" / "manifest.json")
                          .read_text())
    assert manifest["n_hosts"] == 1 and manifest["mesh"] == {
        "axes": ["data", "model"], "shape": [1, 1]}
    assert any((tmp_path / "hb").iterdir())


def test_example_model_equals_the_reference():
    """The example's config at 2 layers (full width: d 640, 10 heads, 5 kv
    heads, d_ff 2560, vocab 16128, naive attention, fp32) against the
    reference example's: loss and every gradient leaf to 1e-4."""
    ex = _example("torch_distributed_pretrain")
    ref = _example("distributed_pretrain")
    jcfg = dataclasses.replace(ref.make_100m_config(), n_layers=2)
    cfg = dataclasses.replace(ex.make_100m_config(), n_layers=2)
    assert (jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.d_ff,
            jcfg.vocab, jcfg.dtype) == (cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.d_ff, cfg.vocab,
                                        cfg.dtype)
    model = jax_build(jcfg)
    jp = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                               "cpu", trainable=True)
    got = build_model(cfg).loss_fn(params, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-4)
    named = dict(params.named_parameters())
    for n, path, i in lm_leaf_paths(cfg, grads):
        np.testing.assert_allclose(named[n].grad.numpy(),
                                   _leaf(grads, path, i), rtol=1e-4,
                                   atol=1e-4, err_msg=n)
