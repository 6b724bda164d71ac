"""Build a kernel's CUDA source into a shared library and load it.

Every kernel of the port is a ``csrc/*.cu`` file with a plain C interface.
At first use it is compiled with ``nvcc`` for ``sm_90a`` into
``build/torch_ext/`` at the root of the checkout (``.gitignore`` lists
``build/``), named by the hash of its source and of every header it
includes from its own directory or from ``kernels/csrc/`` (the shared
Hopper primitives, ``hopper.cuh``), so an edited kernel or header is
rebuilt, and loaded with ``ctypes``.  nvcc's output, with ptxas' register
and shared-memory report, is kept beside the library as ``<name>.log``.
Builds of different sources may run at the same time (in threads or
processes): each writes a temporary file and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-I{INCLUDE_DIR}")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def included_headers(source: Path,
                     include_dirs: tuple = (INCLUDE_DIR,)) -> list:
    """Every file ``source`` pulls in through ``#include "..."``, directly
    or through another header, found beside the including file or in
    ``include_dirs`` (nvcc's search order for quoted includes); in the
    order first met.  System headers (``<...>``) are not followed."""
    found, todo = [], [Path(source)]
    while todo:
        cur = todo.pop(0)
        for name in _INCLUDE.findall(cur.read_text()):
            for d in (cur.parent, *map(Path, include_dirs)):
                hdr = (d / name).resolve()
                if hdr.is_file():
                    if hdr not in found:
                        found.append(hdr)
                        todo.append(hdr)
                    break
    return found


def library_path(source: Path, include_dirs: tuple = (INCLUDE_DIR,)
                 ) -> Path:
    """The library built from ``source``: named by the hash of the source
    and of every header it includes from ``include_dirs``."""
    h = hashlib.sha256(Path(source).read_bytes())
    for hdr in included_headers(source, include_dirs):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def load(source: Path) -> ctypes.CDLL:
    """Compile ``source`` unless its library exists, then load it."""
    so = library_path(source)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def ptxas_report(source: Path) -> list:
    """The register and shared-memory lines ptxas printed for ``source``."""
    log = library_path(source).with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    return [ln.split("info    : ")[-1] for ln in lines if "registers" in ln]


def require_local(*tensors) -> None:
    """Raise for a distributed tensor: a kernel reads its operands through
    their data pointers, which only a rank's local tensor has (call
    ``to_local()`` first)."""
    for t in tensors:
        if hasattr(t, "to_local"):
            raise TypeError(f"a kernel takes local tensors, not "
                            f"{type(t).__name__} (call to_local() first)")
