"""No module that a run loads has the top-level name of JAX, jaxlib, flax
or the JAX package (``repro``; the port's ``repro_torch`` differs as a
whole name), and the reference loads nothing of the program either."""

import ast
import subprocess
import sys

from tiny import CELLS, ROOT, make_root, run_cpu

BANNED = {"jax", "jaxlib", "flax", "repro"}

LIST_MODULES = """
import atexit
atexit.register(lambda: print(sorted({m.split(".")[0] for m in sys.modules}),
                              file=sys.stderr))
"""


def test_a_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    for cell in CELLS:
        res = run_cpu(root, cell, patch=LIST_MODULES)
        assert res.returncode == 0, res.stderr[-2000:]
        loaded = set(ast.literal_eval(res.stderr.strip().splitlines()[-1]))
        assert "repro_torch" in loaded
        assert not loaded & BANNED


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import chipbench.reference.moe\n"
            "import chipbench.weights, chipbench.traffic, chipbench.correct\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    loaded = set(ast.literal_eval(res.stdout.strip().splitlines()[-1]))
    assert not loaded & (BANNED | {"repro_torch"})


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "chipbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BANNED | {"repro_torch"}, \
                    (path.name, name)
