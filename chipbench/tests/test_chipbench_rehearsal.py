"""CPU rehearsals of every cell at a tiny width: a run prints a last line
of the contract's form, plain and traced; without a card, or in a
directory that holds only the benchmark, it exits non-zero and prints no
result."""

import json
import shutil
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT, make_root, run_cpu

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", list(CELLS))
def test_rehearsal_prints_the_result_line(tiny_root, cell, trace):
    res = run_cpu(tiny_root, cell, trace=trace)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert RESULT_KEYS <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, res.stderr[-2000:]
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    for m in wanted:
        if cell in m.get("workloads", [cell]) and m["name"] in line["metrics"]:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "optim_state_gb" in line["metrics"]
    else:
        assert set(line["metrics"]) == {m["name"] for m in wanted}
    tail = res.stderr.strip().splitlines()[-3:]
    assert [t.split()[0] for t in tail] == list(line["checks"])


def test_no_card_no_result():
    res = subprocess.run([sys.executable, str(ROOT / "chipbench" / "run.py"),
                          "--workload", next(iter(CELLS)), "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                          next(iter(CELLS)), "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
