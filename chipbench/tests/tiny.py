"""A checkout-shaped directory holding the benchmark's cells at a tiny
width, for CPU rehearsals: the same families, traffic kind and batch
layout as the real cells, a few hundredths of their size, with limits of
their own."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"granite-moe-1b-a400m.train_4k": "granite-moe-1b-a400m"}
TINY = {
    "moe": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                head_dim=32, d_ff=64, moe_d_ff=64, vocab=500, n_experts=8,
                top_k=2, block_q=64, block_kv=64),
}
SEQ_LEN = 128
# The tiny cells' limits: over the program's readings at this width on the
# CPU (12 seeds: loss_gap to 2.8e-4, grad_norm_gap to 0.030,
# change_norm_gap to 4.8e-3), under the half-batch fault's (grad_norm_gap
# 0.28-0.48).  The cells' own limits are read on the card at their size.
TINY_LIMITS = {"loss_gap": 1e-3, "grad_norm_gap": 0.1,
               "change_norm_gap": 0.01}


def make_root(tmp: Path) -> Path:
    """``tmp`` laid out as a checkout: BENCHMARK.json and the data files
    of every cell, each configuration cut to ``TINY``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = tmp / "chipbench"
    for sub in ("configs", "workloads", "traffic"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    for conf in bench["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        cfg.update(TINY[cfg["family"]])
        (tmp / conf["file"]).write_text(json.dumps(cfg))
    for cell in bench["workloads"]:
        src = ROOT / "chipbench" / "workloads" / f"{cell['name']}.json"
        workload = json.loads(src.read_text())
        workload["limits"] = TINY_LIMITS
        (data / "workloads" / src.name).write_text(json.dumps(workload))
        traffic = json.loads((ROOT / "chipbench" / "traffic"
                              / f"{cell['traffic']}.json").read_text())
        traffic["seq_len"] = SEQ_LEN
        (data / "traffic" / f"{cell['traffic']}.json").write_text(
            json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


RUN = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
{patch}
from pathlib import Path
from chipbench import harness
sys.exit(harness.main({argv!r}, device="cpu", root=Path({tiny!r})))
"""


def run_cpu(tiny: Path, cell: str, *, seed: int = 7, trace: int = 0,
            patch: str = "") -> subprocess.CompletedProcess:
    """One run of ``cell`` on the CPU in a fresh process, ``patch``
    (Python source) run first."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "1",
            "--trace", str(trace)]
    code = RUN.format(src=str(ROOT / "src"), root=str(ROOT), patch=patch,
                      argv=argv, tiny=str(tiny))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
