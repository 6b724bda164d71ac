"""The port's one-card launch layer: the cost-probe modes against the
reference's, the probe's extrapolation, the kernel-true terms against
``repro/launch/perf.py``, the card's peaks against the bounds ``PERF.md``
prints, the roofline against ``repro/launch/roofline.py``, and the dry
run on the CPU."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

# repro.launch.perf sets XLA_FLAGS to 512 host devices when imported; with
# JAX's backend up first the flag has no effect
jax.devices()

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import perf as jperf  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro.models.model import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import costs, dryrun, hw, probe, roofline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import (attention, layers, moe, ssm,  # noqa: E402
                                xlstm)
from repro_torch.models.model import build_model, reduce_config  # noqa: E402

torch.set_num_threads(1)

FAMILIES = {"dense": "llama3.2-3b", "moe": "granite-moe-1b-a400m",
            "hybrid": "zamba2-7b", "ssm": "xlstm-1.3b",
            "audio": "whisper-tiny", "vlm": "llama-3.2-vision-11b"}
# sequences at which the reference's o = q + v broadcasts in every
# attention (a cross call's keys are the frames / image tokens)
SEQ = {"audio": 16, "vlm": 8}
CROSS = {"vlm": "cross_blocks", "audio": "dec_blocks"}
EXTRA = {"vlm": ("image_embeds", "image_tokens"),
         "audio": ("enc_frames", "encoder_seq")}


def _reduced(pkg_reduce, archs, family, probe_mode=False, **over):
    kw = dict(dtype="float32", **(probe.PROBE_MODE if probe_mode else {}))
    if family in ("dense", "vlm"):
        kw["n_kv_heads"] = 2                  # GQA: v repeated to q's heads
    if family == "audio":
        kw["encoder_layers"] = 4              # a period is one layer of each
    if family == "hybrid":
        kw["n_layers"] = 4                    # whole periods, no tail
    kw.update(over)
    return pkg_reduce(archs[FAMILIES[family]], **kw)


# ---------------------------------------------------------------------------
# probe modes: the port's outputs equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_probe_mode_forward_matches_the_reference(family):
    jcfg = _reduced(jax_reduce, JAX_ARCHS, family, probe_mode=True)
    tcfg = _reduced(reduce_config, ARCHS, family, probe_mode=True)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if family in CROSS:     # at the reference's init tanh(xgate) = 0
        n = jp[CROSS[family]]["xgate"].shape[0]
        jp[CROSS[family]]["xgate"] = jnp.asarray(0.5 + 0.3 * np.arange(n),
                                                 jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab, (2, SEQ.get(family, 24)), np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if family in EXTRA:
        key, n = EXTRA[family]
        extra = rng.standard_normal((2, getattr(tcfg, n), tcfg.d_model)
                                    ).astype(np.float32)
        jb[key], tb[key] = jnp.asarray(extra), torch.from_numpy(extra)
    want = np.asarray(jax.jit(jm.forward)(jp, jb), np.float32)
    with torch.no_grad():
        got = build_model(tcfg).forward(tp, tb).float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mlp_skip_returns_its_input():
    x = torch.randn(2, 3, 8)
    assert layers.swiglu({}, x, skip=True) is x


def test_cross_skip_with_other_key_lengths_adds_the_mean_of_v():
    """Where the reference's q + v cannot broadcast (Sq != Skv) the port's
    skip mode adds v's mean over the keys (no S^2 mixing either way)."""
    cfg = reduce_config(ARCHS["llama-3.2-vision-11b"], dtype="float32",
                        attention_impl="skip")
    p = build_model(cfg).init(0, device="cpu").cross_blocks[0].xattn
    x, kv = torch.randn(2, 5, cfg.d_model), torch.randn(2, 8, cfg.d_model)
    got = attention.attention_forward(cfg, p, x, positions=None, kv_x=kv,
                                      causal=False, use_rope=False)
    b, h, hd = 2, cfg.n_heads, cfg.head_dim
    q = layers.dense(p["wq"], x, torch.float32).view(b, 5, h, hd)
    v = layers.dense(p["wv"], kv, torch.float32).view(b, 8, -1, hd)
    v = attention._repeat_kv(v, h // cfg.n_kv_heads)
    want = layers.dense(p["wo"], (q + v.mean(1, keepdim=True))
                        .reshape(b, 5, h * hd), torch.float32)
    torch.testing.assert_close(got, want)


def _refuse(*_, **__):
    raise AssertionError("a kernel wrapper was called in probe mode")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_probe_mode_calls_no_kernel(kind, monkeypatch):
    for mod, name in ((attention, "flash_attention"),
                      (layers, "fused_swiglu"), (moe, "fused_swiglu"),
                      (ssm, "ssd_scan"), (xlstm, "mlstm_scan")):
        monkeypatch.setattr(mod, name, _refuse)
    for family in FAMILIES:
        cfg = _reduced(reduce_config, ARCHS, family, remat=True)
        probe.run_probe(cfg, ShapeConfig("t", SEQ.get(family, 24), 2, kind),
                        device="cpu")


# ---------------------------------------------------------------------------
# extrapolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_extrapolation_equals_a_direct_count(family, kind):
    cfg = _reduced(reduce_config, ARCHS, family, remat=True)
    shape = ShapeConfig("t", SEQ.get(family, 24), 4, kind)
    p = probe.run_probe(cfg, shape, microbatches=2, device="cpu")
    micro = dataclasses.replace(shape, global_batch=2)
    full = probe.count_step(dataclasses.replace(cfg, **probe.PROBE_MODE),
                            micro, device="cpu")
    assert p["n_periods"] >= 2
    for key in ("flops", "bytes"):
        update = full.get(f"update_{key}", 0.0)
        want = 2 * (full[key] - update) + update
        assert p[f"counted_{key}"] == pytest.approx(want, rel=1e-12), key
    assert p["param_bytes"] == full["param_bytes"]
    assert p["state_bytes"] == 2 * full["state_bytes"]
    kt = costs.kernel_true(cfg, shape, costs.skipped_kernels(cfg, kind))
    assert p["flops"] == p["counted_flops"] + kt["flops"]
    assert p["bytes"] == p["counted_bytes"] + kt["bytes"]
    assert probe.check_linearity(cfg, shape, p, device="cpu") == \
        {"flops": 0.0, "bytes": 0.0}


def test_probe_counts_the_dense_projections_as_reckoned():
    cfg = _reduced(reduce_config, ARCHS, "dense")
    p = probe.run_probe(cfg, ShapeConfig("t", 24, 2, "prefill"),
                        device="cpu")
    assert p["flops_per_period"] == probe.forward_period_matmul_flops(
        cfg, 2 * 24)


def test_slstm_recurrence_is_counted_step_by_step():
    """The eager sLSTM loop's wh matvecs (8 b d^2 a step) are in the
    probe's per-period FLOPs: S steps where the reference's scan counts
    one and adds ``slstm_correction`` for the other S - 1."""
    cfg = _reduced(reduce_config, ARCHS, "ssm")
    s, b = 24, 2
    p = probe.run_probe(cfg, ShapeConfig("t", s, b, "prefill"),
                        device="cpu")
    corr = probe.slstm_correction(cfg, ShapeConfig("t", s, b, "prefill"))
    d = cfg.d_model
    assert corr["flops"] == (s - 1) * (8 * b * d * d + 20 * b * d)
    assert p["flops_per_period"] >= s * 8 * b * d * d


# ---------------------------------------------------------------------------
# kernel-true terms against the reference's at chips = 16
# ---------------------------------------------------------------------------

# widths that are no multiple of 16, so the reference's per-device
# factors at chips = 16 are one card's
ODD = dict(d_model=100, d_ff=200, head_dim=20, n_heads=5, n_kv_heads=5)
TERMS = {"attention": "kernel_true_attention", "mlp": "kernel_true_mlp",
         "moe_ffn": "kernel_true_moe_ffn", "mixer": "kernel_true_mixer"}


def _odd(pkg_reduce, archs, family):
    over = dict(ODD)
    if family == "moe":
        over.update(n_experts=6, moe_d_ff=200)
    return pkg_reduce(archs[FAMILIES[family]], **over)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_kernel_true_terms_equal_the_reference_at_sixteen_chips(family,
                                                                shape):
    jcfg = _odd(jax_reduce, JAX_ARCHS, family)
    tcfg = _odd(reduce_config, ARCHS, family)
    for n in (tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_ff, tcfg.d_inner,
              tcfg.n_ssm_heads, tcfg.n_experts or 1):
        assert n % 16, n
    parts = set(costs.skipped_kernels(tcfg, SHAPES[shape].kind))
    assert parts, family
    for part in parts:
        want = getattr(jperf, TERMS[part])(jcfg, JAX_SHAPES[shape], 16)
        got = costs.KERNEL_TRUE[part](tcfg, SHAPES[shape])
        for key in ("flops", "bytes"):
            assert got[key] == pytest.approx(want[key], rel=1e-12), \
                (part, key)


def test_decode_terms_count_one_token_per_sequence():
    cfg = ARCHS["granite-moe-1b-a400m"]
    shape = SHAPES["decode_32k"]
    kt = costs.kernel_true(cfg, shape, costs.skipped_kernels(cfg, "decode"))
    assert set(kt["parts"]) == {"moe_ffn"}
    one = ShapeConfig("d", 1, shape.global_batch, "decode")
    assert kt["parts"]["moe_ffn"] == costs.kernel_true_moe_ffn(cfg, one)


# ---------------------------------------------------------------------------
# the card's peaks reproduce every bound PERF.md §6 prints
# ---------------------------------------------------------------------------

# (kernel, case, dtype, the bound ms as printed)
PERF_BOUNDS = [
    ("flash", (2, 24, 8, 4096, 4096, 128, True), "bfloat16", "0.2085"),
    ("flash", (1, 24, 8, 4096, 4096, 128, True), "bfloat16", "0.1043"),
    ("flash", (2, 32, 32, 4096, 4096, 112, True), "bfloat16", "0.2433"),
    ("flash", (2, 16, 8, 4096, 4096, 64, True), "bfloat16", "0.0695"),
    ("ssd", (2, 4096, 112, 64, 64, 256), None, "0.1601"),
    ("mlstm", (2, 4096, 4, 1024, 256), None, "0.3208"),
    ("swiglu", (1, 8192, 3072, 8192), "bfloat16", "0.8338"),
    ("swiglu", (1, 4096, 3072, 8192), "bfloat16", "0.4169"),
    ("swiglu", (1, 8192, 3584, 14336), "bfloat16", "1.702"),
    ("flash", (1, 32, 32, 4096, 4096, 112, True), "bfloat16", "0.1216"),
    ("ssd", (1, 4096, 112, 64, 64, 256), None, "0.0801"),
    ("mlstm", (1, 1024, 4, 1024, 256), None, "0.0401"),
    ("swiglu", (1, 4096, 3584, 14336), "bfloat16", "0.8512"),
    ("swiglu", (32, 2560, 1024, 512), "bfloat16", "0.1737"),
    ("flash", (2, 32, 8, 4096, 4096, 128, True), "bfloat16", "0.2780"),
    ("flash", (2, 32, 8, 4096, 1600, 128, False), "bfloat16", "0.2171"),
    ("flash", (8, 6, 6, 1500, 1500, 64, False), "bfloat16", "0.0280"),
    ("swiglu", (1, 8192, 4096, 14336), "bfloat16", "1.946"),
    ("swiglu", (1, 12000, 384, 1536), "bfloat16", "0.0286"),
    ("swiglu", (1, 3584, 384, 1536), "bfloat16", "0.0085"),
    ("flash", (1, 32, 8, 4096, 4096, 128, True), "bfloat16", "0.1390"),
    ("flash", (1, 32, 8, 4096, 1600, 128, False), "bfloat16", "0.1086"),
    ("flash", (4, 6, 6, 1500, 1500, 64, False), "bfloat16", "0.0140"),
    ("flash", (4, 6, 6, 4096, 4096, 64, True), "bfloat16", "0.0521"),
    ("flash", (4, 6, 6, 4096, 1500, 64, False), "bfloat16", "0.0382"),
    ("swiglu", (1, 4096, 4096, 14336), "bfloat16", "0.9728"),
    ("swiglu", (1, 6000, 384, 1536), "bfloat16", "0.0143"),
    ("swiglu", (1, 16384, 384, 1536), "bfloat16", "0.0391"),
]


def _bound(kernel, case, dtype):
    if kernel == "flash":
        return hw.bound_ms(*costs.flash_launch(case, dtype), dtype)
    if kernel == "swiglu":
        return hw.bound_ms(*costs.swiglu_launch(case, dtype), dtype)
    launch = costs.ssd_launch if kernel == "ssd" else costs.mlstm_launch
    return hw.bound_ms(*launch(case), "tfloat32")


@pytest.mark.parametrize("kernel,case,dtype,printed", PERF_BOUNDS,
                         ids=[f"{k}-{'x'.join(map(str, c[:6]))}"
                              for k, c, _, _ in PERF_BOUNDS])
def test_bounds_in_perf_md_are_reproduced(kernel, case, dtype, printed):
    ms, by = _bound(kernel, case, dtype)
    digits = len(printed.split(".")[1])
    if ms >= 1:
        assert f"{ms:.4g}" == printed
    else:
        assert f"{ms:.{digits}f}" == printed
    # flash and SwiGLU are bound by operations at these shapes, except the
    # small-K whisper MLPs; SSD and mLSTM by bytes
    if kernel in ("ssd", "mlstm"):
        assert by == "bytes"


def test_peaks_are_keyed_by_card_name():
    card = hw.peaks("NVIDIA H100 80GB HBM3")
    assert card.flops["bfloat16"] == 989e12
    assert card.flops["tfloat32"] == 495e12
    assert card.flops["float32"] == 67e12
    assert card.hbm_bytes_per_s == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        hw.peaks("NVIDIA A100-SXM4-40GB")


def test_measure_needs_the_card():
    with pytest.raises(RuntimeError):
        hw.measure("cpu")


# ---------------------------------------------------------------------------
# roofline against the reference's formulas (one chip, no collectives)
# ---------------------------------------------------------------------------

def test_model_flops_equal_the_reference_at_one_chip():
    """The reference's 6NT / 2NT / 2N at one chip, N without an untied
    input embedding table (a gather: with it llama3.2-3b's prefill claimed
    1.012x the FLOPs it computes, a roofline fraction above 1)."""
    mult = {"train": 6, "prefill": 2, "decode": 2}
    for arch, cfg in ARCHS.items():
        table = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
        n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
        assert roofline.matmul_params(cfg) == n - table
        for name, shape in SHAPES.items():
            tokens = shape.global_batch * (
                1 if shape.kind == "decode" else shape.seq_len)
            want = jroofline.model_flops_per_device(arch, name, 1) \
                - mult[shape.kind] * table * tokens
            assert roofline.model_flops(cfg, shape) == pytest.approx(
                want, rel=1e-12), (arch, name)
    assert not ARCHS["llama3.2-3b"].tie_embeddings
    assert ARCHS["granite-moe-1b-a400m"].tie_embeddings


@pytest.mark.parametrize("flops,nbytes", [(1e15, 1e12), (1e13, 1e12)])
def test_analyze_cell_matches_the_reference(flops, nbytes, monkeypatch):
    card = hw.H100_SXM
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", card.flops["bfloat16"])
    monkeypatch.setattr(jroofline, "HBM_BW", card.hbm_bytes_per_s)
    shape = SHAPES["train_4k"]
    # a tied table: N is the reference's active parameter count
    arch = "granite-moe-1b-a400m"
    cfg = ARCHS[arch]
    want = jroofline.analyze_cell({
        "status": "ok", "arch": arch, "shape": "train_4k",
        "mesh": "pod", "chips": 1,
        "probe": {"flops": flops, "bytes": nbytes, "collective_bytes": 0.0},
        "memory_analysis": {}})
    got = roofline.analyze_cell({
        "status": "ok", "arch": arch, "shape": "train_4k",
        "kind": "train", "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "device": "NVIDIA H100 80GB HBM3",
        "matmul_param_count": roofline.matmul_params(cfg),
        "probe": {"flops": flops, "bytes": nbytes},
        "reckoned": {"total_bytes": 1.0}, "measured_peak_bytes": None},
        step_s=30.0)
    assert want["t_collective_s"] == 0.0
    for key in ("t_compute_s", "t_memory_s", "dominant",
                "useful_compute_ratio", "roofline_fraction"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["model_flops"] == want["model_flops_per_dev"]
    assert got["mfu"] == pytest.approx(
        got["model_flops"] / 30.0 / card.flops["bfloat16"])


def test_roofline_skips_records_without_a_probe():
    assert roofline.analyze_cell({"status": "error"}) is None
    assert roofline.analyze_cell({"status": "skipped"}) is None


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_reduced_dry_run_writes_a_record(tmp_path, capsys):
    cfg = reduce_config(ARCHS["zamba2-7b"])
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    rec = dryrun.run_cell("zamba2-7b", "train_4k", tmp_path, device="cpu",
                          cfg=cfg, shape=shape, force=True)
    path = tmp_path / "zamba2-7b__train_4k__1gpu.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(rec))
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["microbatch"] * rec["microbatches"] == shape.global_batch
    assert rec["measured_peak_bytes"] is None       # not measured on a CPU
    r = rec["reckoned"]
    assert r["total_bytes"] == pytest.approx(4 * r["param_bytes"])
    assert rec["probe"]["kernel_true"]["parts"].keys() == \
        {"attention", "mlp", "mixer"}
    row = roofline.analyze_cell(rec)
    assert row["t_compute_s"] > 0 and row["roofline_fraction"] <= 1
    roofline.main(["--results", str(tmp_path), "--table", "all",
                   "--step-s", "zamba2-7b:train_4k=1.0"])
    assert "zamba2-7b" in capsys.readouterr().out
    skipped = dryrun.run_cell("llama3.2-3b", "long_500k", tmp_path,
                              device="cpu")
    assert skipped["status"] == "skipped"


def test_decode_microbatch_fits_the_card():
    cfg, shape = ARCHS["llama3.2-3b"], SHAPES["decode_32k"]
    mb = dryrun.choose_microbatch(cfg, shape, hw.HBM_BYTES)
    assert mb and shape.global_batch % mb == 0
    fits = cfg.param_count() * 2 + dryrun._decode_state_bytes(
        cfg, mb, shape.seq_len)
    over = cfg.param_count() * 2 + dryrun._decode_state_bytes(
        cfg, 2 * mb, shape.seq_len)
    assert fits <= hw.HBM_BYTES < over


def test_launch_train_dry_run_returns_the_record(tmp_path, capsys):
    rec = launch_train.main(["--arch", "llama3.2-3b", "--test-mesh",
                             "--device", "cpu", "--dry-run",
                             "--microbatches", "2",
                             "--dryrun-dir", str(tmp_path)])
    assert rec["status"] == "ok" and rec["microbatches"] == 2
    assert (tmp_path / "llama3.2-3b__train_4k__1gpu.json").exists()
    assert "OK" in capsys.readouterr().out
