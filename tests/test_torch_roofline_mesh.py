"""The roofline's collective term against the reference's, and the mesh
dry run of a decode cell and an int8 train cell.

``roofline.analyze_cell`` on a mesh record (per rank: counted FLOPs and
bytes, the tally's ``collective_bytes``, the mesh's chip count) is held
to ``repro.launch.roofline.analyze_cell`` on the same numbers, with the
reference module's ``PEAK_FLOPS_BF16``, ``HBM_BW`` and ``ICI_BW`` set to
the H100's data sheet (``launch/hw.py``: 989e12, 3.35e12 and the NVLink
rate of one direction, 450e9) through ``monkeypatch``: nothing of
``src/repro`` changes.  Each of the three terms is made the slowest in
turn.  One-card rows keep their two terms, computed as before.  Then
``dryrun.run_mesh_cell`` on 4 gloo ranks on (2, 2) builds a reduced
zamba2-7b ``long_500k`` decode cell (batch 1: the cache's positions over
``data``) and a reduced granite-34b train cell, which takes the
reference's int8 moments (``OPT_STATE_DTYPE``); each record has its
roofline row with the collective term.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import hw, roofline  # noqa: E402
from torch_dist_util import run_ranks  # noqa: E402

pytestmark = pytest.mark.xdist_group("roofline_mesh")

CARD = hw.H100_SXM
# (flops, bytes, collective bytes) a rank: each term the slowest in turn
NUMBERS = {"compute": (5e14, 1e11, 1e9), "memory": (1e12, 8e12, 1e9),
           "collective": (1e12, 1e11, 4e12)}


@pytest.fixture
def card_reference(monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", CARD.flops["bfloat16"])
    monkeypatch.setattr(jroofline, "HBM_BW", CARD.hbm_bytes_per_s)
    monkeypatch.setattr(jroofline, "ICI_BW", CARD.link_bytes_per_s)
    return jroofline


@pytest.mark.parametrize("arch,shape_name", [("llama3.2-3b", "train_4k"),
                                             ("zamba2-7b", "long_500k")])
@pytest.mark.parametrize("slowest", list(NUMBERS))
def test_mesh_row_equals_the_reference(card_reference, slowest, arch,
                                       shape_name):
    flops, nbytes, coll = NUMBERS[slowest]
    shape = SHAPES[shape_name]
    want = card_reference.analyze_cell({
        "status": "ok", "arch": arch, "shape": shape_name, "mesh": "2x2",
        "chips": 4, "probe": {"flops": flops, "bytes": nbytes,
                              "collective_bytes": coll},
        "memory_analysis": {}})
    cfg = JAX_ARCHS[arch]
    got = roofline.analyze_cell({
        "status": "ok", "arch": arch, "shape": shape_name, "mesh": "2x2",
        "chips": 4, "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "device": "NVIDIA H100 80GB HBM3",
        # the reference's N: every parameter (active ones for an MoE)
        "matmul_param_count": cfg.active_param_count() if cfg.is_moe
        else cfg.param_count(),
        "probe": {"flops": flops, "bytes": nbytes},
        "collectives": {"collective_bytes": coll},
        "measured_peak_bytes": None}, step_s=2.0)
    assert got["dominant"] == want["dominant"] == slowest
    for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                "useful_compute_ratio", "roofline_fraction"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["model_flops_per_dev"] == pytest.approx(
        want["model_flops_per_dev"], rel=1e-12)
    assert got["t_collective_s"] == coll / 450e9
    assert got["mfu"] == pytest.approx(
        got["model_flops_per_dev"] / 2.0 / CARD.flops["bfloat16"])


def test_nvlink_rate_is_the_data_sheet_direction():
    assert CARD.link_bytes_per_s == hw.LINK_BYTES_PER_S == 900e9 / 2


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_one_card_rows_keep_two_terms(arch):
    """A record without ``chips`` is one card's: its row has the compute
    and memory terms only, the two-way ``dominant`` and the model FLOPs
    of the whole step, as before the collective term."""
    shape = SHAPES["train_4k"]
    cfg = ARCHS[arch]
    flops, nbytes = 3e15, 4e12
    row = roofline.analyze_cell({
        "status": "ok", "arch": arch, "shape": "train_4k", "kind": "train",
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "device": "NVIDIA H100 80GB HBM3",
        "matmul_param_count": roofline.matmul_params(cfg),
        "probe": {"flops": flops, "bytes": nbytes},
        "reckoned": {"total_bytes": 1.0}, "measured_peak_bytes": None})
    t_c, t_m = flops / CARD.flops["bfloat16"], nbytes / CARD.hbm_bytes_per_s
    mf = 6.0 * roofline.matmul_params(cfg) * shape.global_batch \
        * shape.seq_len
    assert "t_collective_s" not in row and "chips" not in row
    assert (row["t_compute_s"], row["t_memory_s"]) == (t_c, t_m)
    assert row["dominant"] == ("compute" if t_c >= t_m else "memory")
    assert row["model_flops"] == mf
    assert row["useful_compute_ratio"] == mf / flops
    assert row["roofline_fraction"] == (mf / max(t_c, t_m)) \
        / CARD.flops["bfloat16"]


@pytest.fixture(scope="module")
def mesh_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_cells")
    run_ranks("mesh_cells", out, timeout=240)
    return torch.load(out / "mesh_cells_out.pt", weights_only=False), out


def test_run_mesh_cell_builds_a_long_context_decode_cell(mesh_records):
    recs, out = mesh_records
    rec = recs["zamba2-7b"]
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert (rec["global_batch"], rec["chips"], rec["mesh"]) == (1, 4, "2x2")
    row = rec["roofline"]
    assert row["t_collective_s"] == \
        rec["collectives"]["collective_bytes"] / CARD.link_bytes_per_s > 0
    assert row["dominant"] in ("compute", "memory", "collective")
    assert rec["probe"]["flops"] > 0 and rec["probe"]["bytes"] > 0
    # the combine over the cache's blocks of positions: all-reduces
    assert rec["collectives"]["per_op"]["all-reduce"]["count"] > 0
    on_disk = json.loads((out / "dryrun" /
                          "zamba2-7b__long_500k__2x2.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))


def test_run_mesh_cell_trains_with_the_reference_int8_moments(mesh_records):
    recs, _ = mesh_records
    rec = recs["granite-34b"]
    assert rec["state_dtype"] == "int8" and rec["kind"] == "train"
    assert rec["loss"] > 0 and rec["roofline"]["t_collective_s"] > 0
    assert rec["roofline"]["model_flops_per_dev"] == pytest.approx(
        rec["roofline"]["model_flops"] / 4)
    text = roofline.format_table([rec["roofline"]])
    assert "2x2" in text and "granite-34b" in text
