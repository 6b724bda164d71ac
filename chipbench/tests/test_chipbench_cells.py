"""The benchmark's data: every cell in BENCHMARK.json loads, names files
that exist, a reference family, and a reader for each of its per-layer
metrics; every configuration's parameters are the program's; the file
keeps the contract's limits."""

import dataclasses
import importlib
import json
import re
import sys

import pytest

from tiny import ROOT

sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chipbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_and_names_what_exists(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.rows % c.micro == 0
    assert c.traffic["seq_len"] > 0
    mod = harness.reference_module(c)
    assert callable(mod.loss) and callable(mod.layout)
    assert set(c.workload["limits"]) == {"loss_gap", "grad_norm_gap",
                                         "change_norm_gap"}
    for m in BENCH["per_layer"]:
        if c.applies(m):
            reader = importlib.import_module(f"chipbench.metrics.{m['name']}")
            assert callable(reader.read)
    assert sum(c.applies(m) for m in BENCH["end_to_end"]) >= 2
    assert any(c.applies(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("conf", [c["name"] for c in BENCH["configs"]])
def test_reference_layout_is_the_programs(conf):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import build_model
    entry = next(c for c in BENCH["configs"] if c["name"] == conf)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    shapes = build_model(ModelConfig(**{k: v for k, v in cfg.items()
                                        if k in fields})).param_shapes()
    mod = importlib.import_module(f"chipbench.reference.{cfg['family']}")
    layout = {n: tuple(s) for n, s, _ in mod.layout(cfg)}
    assert layout == {n: tuple(s) for n, s in shapes.items()}
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024
