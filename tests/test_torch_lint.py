"""The port's admission lint (``tools/lint_invariants_torch.py``): clean on
the tree because the three admitting modules are admitted and keep their
tripwires; a forged unadmitted ``.run(schedule=...)`` is flagged; an
admitted module that loses its tripwire fails the lint."""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
TOOL = ROOT / "tools" / "lint_invariants_torch.py"
PORT = ROOT / "src" / "repro_torch"


def _lint():
    spec = importlib.util.spec_from_file_location("lint_torch", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _copy(tmp_path):
    dst = tmp_path / "repro_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.so", "build"))
    return dst


def test_port_lint_passes_on_the_tree():
    res = subprocess.run([sys.executable, str(TOOL)], capture_output=True,
                         text=True, cwd=ROOT)
    assert res.returncode == 0, res.stdout
    assert "clean" in res.stdout
    lint = _lint()
    # the scan covers the whole port, and the admitted modules do hold
    # backend calls the reference's allowlist would flag
    findings = [lint.lint_file(p, p.relative_to(PORT.parent).as_posix())
                for p in sorted(PORT.rglob("*.py"))]
    assert sum(map(len, findings)) == 0
    admitted = {rel: len(lint.lint_file(PORT.parent / rel, "unadmitted.py"))
                for rel in lint.RUN_ALLOWLIST}
    assert all(n > 0 for n in admitted.values()), admitted


def test_port_lint_flags_a_forged_unadmitted_call(tmp_path):
    pkg = _copy(tmp_path)
    (pkg / "forged.py").write_text(
        "def bypass(backend, graph, params, x, y, sched):\n"
        "    return backend.run(graph, params, x, y, schedule=sched)\n")
    res = subprocess.run([sys.executable, str(TOOL), "--src", str(pkg)],
                         capture_output=True, text=True)
    assert res.returncode == 1
    assert "repro_torch/forged.py:2: [admission]" in res.stdout


@pytest.mark.parametrize("rel", ["core/plan.py", "core/exec/backends.py",
                                 "serve/scheduler.py"])
def test_port_lint_fails_when_a_module_loses_its_tripwire(tmp_path, rel):
    lint = _lint()
    pkg = _copy(tmp_path)
    token = lint.RUN_ALLOWLIST[f"repro_torch/{rel}"]
    path = pkg / rel
    path.write_text(path.read_text().replace(token, "unchecked"))
    findings = lint.lint_tree(pkg)
    assert findings == [f"repro_torch/{rel}:1: [admission] admitted module "
                        f"lost its {token} admission check"]
