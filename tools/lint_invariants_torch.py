#!/usr/bin/env python
"""AST lint of the port's admission invariant (``src/repro_torch``).

The port's counterpart of the admission rule of ``tools/lint_invariants.py``,
over every ``.py`` file under ``src/repro_torch/``:

admission
    No code path may call an executor backend's ``run`` or ``start`` entry
    (recognised as ``<anything>.run(..., schedule=...)`` /
    ``<anything>.start(..., schedule=...)``, the ``ExecutorBackend``
    signatures) outside the admitted call sites: ``repro_torch.core.plan``
    (routing through ``_apply_verify``), ``repro_torch.core.exec.backends``
    itself (whose ``run``/``start`` perform the verify admission), and
    ``repro_torch.serve.scheduler`` (whose cursors come only from the
    admission-gated ``start`` and which re-asserts ``is_verified`` per
    cursor).  A new call site would bypass the static verifier.  Each
    admitted module must still contain its admission token, so deleting
    the admission block fails the lint rather than silently unguarding
    every call site.

The reference's deprecated-import rule has no counterpart: the port
carries no shims, and ``tests/test_torch_isolation.py`` forbids importing
the reference package at all.

    python tools/lint_invariants_torch.py [--src DIR]

prints one ``path:line: [admission] message`` per finding and exits
non-zero on any.  ``tools/ci_torch.sh`` runs it.
"""

import argparse
import ast
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"

# modules whose backend-run/start call sites are admission-checked
# (relative to the package's parent) -> the admission token each must
# still contain: the same tokens as the reference's
RUN_ALLOWLIST = {
    "repro_torch/core/plan.py": "mark_verified",
    "repro_torch/core/exec/backends.py": "is_verified",
    "repro_torch/serve/scheduler.py": "is_verified",
}


def lint_file(path: Path, rel: str) -> list:
    """(line, rule, message) of each unadmitted backend call in ``path``."""
    findings = []
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("run", "start") \
                and any(kw.arg == "schedule" for kw in node.keywords) \
                and rel not in RUN_ALLOWLIST:
            findings.append((
                node.lineno, "admission",
                f"backend .{node.func.attr}(schedule=...) outside the "
                "admitted call sites — route through "
                "compile_plan(...).loss_and_grads or the StepScheduler so "
                "the schedule passes verify admission"))
    return findings


def lint_tree(package: Path = PORT) -> list:
    """Every finding under ``package`` (a ``repro_torch`` directory) as
    ``path:line: [rule] message`` lines, tripwires included."""
    package = Path(package)
    root = package.parent
    out = []
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        for lineno, rule, msg in lint_file(path, rel):
            out.append(f"{rel}:{lineno}: [{rule}] {msg}")
    # tripwire: the admitted modules must still perform admission
    for rel, token in sorted(RUN_ALLOWLIST.items()):
        path = root / rel
        if not path.exists() or token not in path.read_text():
            out.append(f"{rel}:1: [admission] admitted module lost its "
                       f"{token} admission check")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's admission lint")
    ap.add_argument("--src", default=str(PORT),
                    help="the repro_torch package directory to scan")
    args = ap.parse_args(argv)
    package = Path(args.src)
    findings = lint_tree(package)
    for line in findings:
        print(line)
    if findings:
        print(f"FAIL {len(findings)} invariant violation(s)")
        return 1
    n = sum(1 for _ in package.rglob("*.py"))
    print(f"port invariant lint clean: {n} files, "
          f"{len(RUN_ALLOWLIST)} admitted modules")
    return 0


if __name__ == "__main__":
    sys.exit(main())
