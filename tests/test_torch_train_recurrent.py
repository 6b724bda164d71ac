"""Port parity for training the hybrid (zamba2-7b) and ssm (xlstm-1.3b)
families against the JAX package.

Reduced configs (the reference's ``reduce_config``: zamba 2 groups of 2
mamba layers and a tail of 1, 4 SSD heads of 32, state 16; xLSTM 2 groups
of 1 mLSTM block and 1 sLSTM block, and the stack without sLSTM blocks) in
float32 at S = 300 (two 256-row chunks, the second ragged, so every SSD and
mLSTM scan runs its inter-chunk recurrence and its padding), zamba also at
S = 48 (one chunk).  Parameters
are the reference's init carried across by ``convert.params_from_numpy(
..., trainable=True)``; batches come from a numpy seed.  The reference
runs ``jax.value_and_grad(model.loss_fn)`` compiled, with remat off (its
offload policy does not lower on the CPU); the port runs with remat off
and on, which must give the same values.  On the CPU each scan's forward
is its kernel's plain twin and its backward the vjp of the port of the
reference's jnp function (``ssm.ssd_chunked``, ``xlstm.mlstm_chunked``).

Tolerances: the loss and every gradient leaf normwise within 1e-4 (the
largest error over the largest value of the reference's leaf).  For zamba
at S = 300 a leaf's tolerance is the larger of 1e-4 and ``SPREAD_FACTOR``
times the reference's own spread on it, its compiled grads against its
op-by-op grads: a mamba layer's ``A_log`` and ``dt_bias`` gradients sum
the reverse cumsum of 256-row log decays that reach thousands, whose
terms cancel, so their float32 values depend on the order of the sums,
and there the reference's two runs differ at the 1e-4 level (on every
other leaf by far less, which keeps 1e-4).  ``chip_smoke.py`` (g) holds
the card's kernel path by a like rule: 2x the distance between the port's
two plain paths.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 lm_leaf_paths, params_from_numpy)
from repro_torch.core import remat  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as M  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel as S  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer, xlstm, zamba  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

torch.set_num_threads(1)

B, SEQ = 1, 300
TOL = 1e-4
SPREAD_FACTOR = 4.0
FP32 = dict(dtype="float32")
# case -> (config overrides, sequence length, whether the reference's own
# spread widens a leaf's tolerance)
CASES = {"zamba2-7b": (FP32, SEQ, True),
         "zamba2-7b, one chunk": (FP32, 48, False),
         "xlstm-1.3b": (FP32, SEQ, False),
         "xlstm-1.3b, no sLSTM": (dict(FP32, slstm_every=0), SEQ, False)}


def _arch(case):
    return case.split(",")[0]


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(vocab, seed=0, b=B, s=SEQ):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _ref_leaf(tree, path, i):
    for k in path:
        tree = tree[k]
    return tree if i is None else tree[i]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(port cfg, reference numpy params, batch, the reference's loss and
    numpy grads), compiled once per case."""
    over, seq, _ = CASES[case]
    jm = jax_build(jax_reduce(JAX_ARCHS[_arch(case)], **over))
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tcfg = reduce_config(ARCHS[_arch(case)], **over)
    batch = _batch(tcfg.vocab, s=seq)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return tcfg, jp, batch, float(loss), \
        jax.tree_util.tree_map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _tolerances(case):
    """Per leaf: 1e-4, or for a case that asks for it the larger of 1e-4
    and ``SPREAD_FACTOR`` x the normwise spread between the reference's
    compiled grads and its op-by-op grads on that leaf."""
    tcfg, jp, batch, _, want = _reference(case)
    paths = list(lm_leaf_paths(tcfg, want))
    if not CASES[case][2]:
        return {name: TOL for name, _, _ in paths}
    jm = jax_build(jax_reduce(JAX_ARCHS[_arch(case)], **CASES[case][0]))
    with jax.disable_jit():
        _, eager = jax.value_and_grad(jm.loss_fn)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    eager = jax.tree_util.tree_map(np.asarray, eager)
    return {name: max(TOL, SPREAD_FACTOR * _rel(_ref_leaf(eager, path, i),
                                                _ref_leaf(want, path, i)))
            for name, path, i in paths}


def _port_grads(case, remat_on):
    tcfg, jp, batch, _, _ = _reference(case)
    cfg = dataclasses.replace(tcfg, remat=remat_on)
    params = params_from_numpy(jp, cfg, "cpu", trainable=True)
    loss = build_model(cfg).loss_fn(params, _torch_batch(batch))
    loss.backward()
    return cfg, loss.detach(), {n: p.grad for n, p in
                                params.named_parameters()}


@pytest.mark.parametrize("remat_on", [False, True],
                         ids=["noremat", "remat"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_grad_match_jax(case, remat_on):
    """``Model.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, normwise 1e-4
    (see the module's docstring for zamba at S = 300); every port leaf has
    its reference leaf (zamba's one shared block gets the sum over its
    applications, as the reference's)."""
    tcfg, _, _, want_loss, want = _reference(case)
    tols = _tolerances(case)
    cfg, loss, grads = _port_grads(case, remat_on)
    assert _rel(loss, want_loss) <= TOL
    names = set(grads)
    bad = {}
    for name, path, i in lm_leaf_paths(cfg, want):
        names.discard(name)
        g = grads[name]
        assert g is not None and bool(torch.isfinite(g).all()), name
        err = _rel(g, _ref_leaf(want, path, i))
        if err > tols[name]:
            bad[name] = (err, tols[name])
    assert not names, f"port leaves without a reference leaf: {names}"
    assert not bad, bad


@pytest.mark.parametrize("case", list(CASES))
def test_remat_gives_the_same_values(case):
    """Checkpointing changes what is held, not what is computed: the loss
    and every gradient with remat on equal remat off bit for bit."""
    _, loss_off, off = _port_grads(case, False)
    _, loss_on, on = _port_grads(case, True)
    assert torch.equal(loss_on, loss_off)
    for n, g in off.items():
        assert torch.equal(on[n], g), n


@pytest.mark.parametrize("case", ["zamba2-7b", "xlstm-1.3b"])
def test_checkpoint_structure(case):
    """With remat on: each mamba, mLSTM and sLSTM block is one region that
    keeps no tagged tensor, holds only its input and is replayed once;
    zamba's shared block is a region of its own under the plan's policy,
    holding the tags that policy keeps."""
    tcfg, jp, batch, _, _ = _reference(case)
    cfg = dataclasses.replace(tcfg, remat=True)
    params = params_from_numpy(jp, cfg, "cpu", trainable=True)
    x_bytes = batch["tokens"].size * cfg.d_model * 4
    with remat.observe_regions() as stats:
        build_model(cfg).loss_fn(params, _torch_batch(batch)).backward()
    assert all(s.replays == 1 and s.offloaded == {} for s in stats)
    if case == "zamba2-7b":
        n_groups, tail = zamba.layout(cfg)
        k = cfg.shared_attn_every
        kinds = (["mamba"] * k + ["shared"]) * n_groups + ["mamba"] * tail
        kept = transformer.memory_plan(cfg, B * SEQ).offload_policy.saved
        for kind, s in zip(kinds, stats):
            if kind == "mamba":
                assert s.kept == {} and s.input_bytes == x_bytes
            else:
                assert set(s.kept) <= set(kept) and s.kept
    else:
        kinds = ["block"] * cfg.n_layers
        assert all(s.kept == {} and s.input_bytes == x_bytes for s in stats)
    assert len(stats) == len(kinds)


def test_slstm_loop_saves_linear_residuals():
    """``slstm_forward``'s loop writes ``ys[:, t] = h`` in place; autograd
    records each write as a CopySlices node and saves no copy of ``ys``
    per step: the bytes saved for the backward grow linearly in S."""
    cfg = dataclasses.replace(reduce_config(ARCHS["xlstm-1.3b"]),
                              dtype="float32")
    gen = torch.Generator("cpu").manual_seed(0)
    params = {k: torch.nn.Parameter(v)
              for k, v in xlstm.slstm_init(gen, cfg, trainable=True).items()}

    def saved_bytes(s):
        total = [0]

        def pack(t):
            total[0] += t.untyped_storage().nbytes()
            return t

        x = torch.randn(1, s, cfg.d_model, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = xlstm.slstm_forward(cfg, params, x)
        y.sum().backward()
        return total[0]

    small, large = saved_bytes(64), saved_bytes(256)
    assert large <= 4.2 * small, (small, large)


def test_twins_stay_forward_only():
    """The chunk kernels' wrappers still refuse nothing on the CPU (the
    twins run), and the scans' backwards never differentiate a twin: a
    training step's backward reaches ``ssd_chunked`` and
    ``mlstm_chunked`` instead."""
    calls = {"ssd": 0, "mlstm": 0}
    ssd_twin, mlstm_twin = S.ssd_chunk_plain, M.mlstm_chunk_plain

    def counted(kind, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            assert not any(t.requires_grad for t in out), kind
            calls[kind] += 1
            return out
        return run

    S.ssd_chunk_plain = counted("ssd", ssd_twin)
    M.mlstm_chunk_plain = counted("mlstm", mlstm_twin)
    try:
        for case in ("zamba2-7b", "xlstm-1.3b"):
            _port_grads(case, True)
    finally:
        S.ssd_chunk_plain, M.mlstm_chunk_plain = ssd_twin, mlstm_twin
    # forward and one replay per mamba layer / mLSTM block
    assert calls == {"ssd": 2 * 5, "mlstm": 2 * 2}


@pytest.mark.parametrize("case", ["zamba2-7b", "xlstm-1.3b"])
def test_train_step_grad_norm_and_plan(case):
    """``make_train_step`` over these trees: the plan is the one the model
    installs, the fp32 grad norm covers every leaf, and two AdamW steps
    from the converted reference state keep every parameter finite."""
    tcfg, jp, batch, _, _ = _reference(case)
    cfg = dataclasses.replace(tcfg, remat=True)
    tm = build_model(cfg)
    params = params_from_numpy(jp, cfg, "cpu", trainable=True)
    from repro.optim import make_optimizer as jax_make_optimizer
    jstate = jax_make_optimizer("adamw").init(
        jax.tree_util.tree_map(jnp.asarray, jp))
    state = adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), cfg, "cpu")
    assert set(state["mu"]) == {n for n, _ in params.named_parameters()}
    bundle = make_train_step(tm, make_optimizer("adamw"),
                             ShapeConfig("t", SEQ, 2, "train"),
                             microbatches=2)
    assert bundle.memory_plan is transformer.memory_plan(cfg, SEQ)
    two = {k: np.concatenate([v, _batch(cfg.vocab, seed=1)[k]])
           for k, v in batch.items()}
    for _ in range(2):
        params, state, metrics = bundle.fn(params, state, _torch_batch(two))
        grads = [p.grad.double() for p in params.parameters()]
        want = torch.sqrt(sum((g * g).sum() for g in grads))
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(want),
                                   rtol=1e-6)
    assert int(state["count"]) == 2
    assert all(bool(torch.isfinite(p).all()) for p in params.parameters())


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_trainer_restarts_bit_for_bit(arch, tmp_path):
    """A 2-step ``Trainer`` run with a checkpoint after step 1, restarted
    from it for step 2, gives the uninterrupted run's losses and
    parameters bit for bit."""
    cfg = dataclasses.replace(reduce_config(ARCHS[arch]), remat=True)
    shape = ShapeConfig("t", 48, 2, "train")

    def run(steps, ckpt=None):
        trainer = Trainer(build_model(cfg), make_optimizer("adamw"), shape,
                          TrainerConfig(steps=steps, log_every=1,
                                        ckpt_every=1, ckpt_dir=ckpt),
                          device="cpu")
        out = trainer.run()
        return [h["loss"] for h in out["history"]], out["params"]

    straight, p_straight = run(2)
    first, _ = run(1, str(tmp_path))
    resumed, p_resumed = run(2, str(tmp_path))
    assert first == straight[:1] and resumed == straight[1:]
    for (n, a), (_, b) in zip(p_straight.named_parameters(),
                              p_resumed.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_launch_train_test_mesh_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch ... --test-mesh
    --device cpu``: the reduced config at sequence 64, batch 8, two steps
    with finite losses near ln(vocab)."""
    out = launch_train.main(["--arch", arch, "--test-mesh", "--device",
                             "cpu", "--steps", "2"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(256)) < 1.0
    assert "final loss" in capsys.readouterr().out
