"""Async, sharded, elastic checkpointing, in the reference's on-disk
layout.

Port of ``repro/checkpoint/ckpt.py``.  One directory per step:

    <dir>/step_<n>/
        manifest.json        — leaf names, global and shard shapes, dtypes,
                               placements, step metadata
        shard_<host>.npz     — this host's (rank's) pieces of the leaves
        data_state.json      — data-stream position

* async: ``save`` copies every leaf to host memory (the blocking part,
  device -> host) and a background thread writes the files;
* per-rank shards: on a mesh (``n_hosts`` ranks, ``host_id`` this one)
  each rank writes only its own blocks, and a block that several ranks
  hold (replicated over ``pod``, or over ``model`` for a weight every
  model rank holds whole) only once, by the rank at index 0 of every
  axis its placement does not use; host 0 waits for every rank's file,
  then writes the manifest (each leaf's placement and the mesh, so a
  block's place in the global leaf is known) and publishes;
* atomic publish: files go to ``step_<n>.tmp``, renamed once the manifest
  is written, so a crash mid-save never leaves a half checkpoint that
  ``all_steps`` would list;
* garbage collection: the last ``keep`` checkpoints stay.

A tree is a nested dict / list / tuple of tensors; leaf names are the
reference's ``jax.tree_util.keystr`` of their path (``[0]['embed']``), so
the manifests read alike.  bfloat16 leaves, which npz cannot hold, are
stored as their uint16 bits and the manifest records ``bfloat16``.

Restore is elastic: one leaf at a time is assembled whole from the shard
files (each block at its place, from the rank that wrote it) and,
given ``shardings``, each rank keeps its block under the current
placement, so a run saved on N ranks resumes on M; without them the whole
leaf.  Either way it is copied into the target tree's tensor, in place,
before the next leaf is read.
:func:`reference_tree` reads a checkpoint the reference wrote back into its
nested tree, from which ``convert.params_from_numpy`` builds the port's
model.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in order: dict keys as ``['k']``, list
    and tuple positions as ``[i]``."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in flatten_with_paths(v, f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` and its dtype name."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).cpu().numpy(), "bfloat16"
    return t.cpu().numpy(), _dtype_name(t)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype)))


# how long host 0 waits for the other ranks' shard files
PUBLISH_TIMEOUT_S = 600.0


def _mesh_info(shardings) -> Optional[Dict]:
    for _, sh in flatten_with_paths(shardings):
        return {"axes": list(sh.mesh.axis_names),
                "shape": list(sh.mesh.shape.values())}
    return None


def _coords(host: int, mesh: Dict) -> Dict[str, int]:
    """Rank ``host``'s mesh coordinates (ranks lie row-major)."""
    idx = np.unravel_index(host, mesh["shape"])
    return {a: int(i) for a, i in zip(mesh["axes"], idx)}


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_id: int = 0, n_hosts: int = 1):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, data_state: Optional[Dict] = None,
             *, blocking: bool = False, shardings: Any = None) -> None:
        """Copy to host memory now; write the files in the background.

        ``shardings`` (a tree of placements matching ``tree``, as a step
        bundle's ``in_shardings``) says which block of each global leaf
        this rank's tensor is; every rank saves with the same tree."""
        self.wait()
        specs = {n: sh for n, sh in flatten_with_paths(shardings)} \
            if shardings is not None else {}
        leaves = flatten_with_paths(tree)
        # every leaf's shape and dtype, this rank's block of the leaves it
        # writes (a replica is written by its first holder only)
        meta = [(name, list(leaf.shape), _dtype_name(leaf))
                for name, leaf in leaves]
        snap = {name: _to_numpy(leaf)[0] for name, leaf in leaves
                if name not in specs or specs[name].first_replica()}
        mesh = _mesh_info(shardings) if shardings is not None else None

        def global_shape(name, shape):
            sh = specs.get(name)
            if sh is None:
                return shape
            return [n * sh.parts(d) for d, n in enumerate(shape)]

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            tmp.mkdir(parents=True, exist_ok=True)
            part = tmp / f"shard_{self.host_id}.part.npz"
            np.savez(part, **snap)
            part.rename(tmp / f"shard_{self.host_id}.npz")
            if self.host_id != 0:
                return
            self._await_shards(tmp)
            manifest = {
                "step": step,
                "time": time.time(),
                "n_hosts": self.n_hosts,
                "mesh": mesh,
                "treedef": f"{len(meta)} leaves",
                "leaves": [
                    {"name": n, "global_shape": global_shape(n, shape),
                     "dtype": dt, "shard_shape": shape,
                     "spec": _spec_json(specs[n].spec) if n in specs
                     else None}
                    for n, shape, dt in meta
                ],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if data_state is not None:
                (tmp / "data_state.json").write_text(json.dumps(data_state))
            tmp.rename(final)
            self._gc()

        def run():
            try:
                write()
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _await_shards(self, tmp: Path) -> None:
        deadline = time.monotonic() + PUBLISH_TIMEOUT_S
        while not all((tmp / f"shard_{h}.npz").exists()
                      for h in range(self.n_hosts)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{tmp}: not every rank's shard arrived "
                                   f"within {PUBLISH_TIMEOUT_S:.0f} s")
            time.sleep(0.05)

    def wait(self) -> None:
        """Wait for the background write; a failure in it (a write error,
        host 0's wait for the other ranks' shards timing out) is raised
        here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") \
                    and (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @contextlib.contextmanager
    def _open(self, step: int):
        """(leaf names in order, ``get``, data state) of checkpoint
        ``step``, its shard files open for the ``with`` body: ``get(name)``
        assembles that one leaf on the host, whole."""
        cdir = self.dir / f"step_{step}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        by_name = {m["name"]: m for m in manifest["leaves"]}
        ds_path = cdir / "data_state.json"
        data_state = json.loads(ds_path.read_text()) if ds_path.exists() \
            else None
        files = [np.load(cdir / f"shard_{h}.npz")
                 for h in range(manifest["n_hosts"])]

        def get(name: str) -> torch.Tensor:
            if name not in by_name:
                raise KeyError(f"{name} missing from checkpoint")
            m = by_name[name]
            return _from_numpy(_assemble(m, files, manifest.get("mesh")),
                               m["dtype"])

        try:
            yield list(by_name), get, data_state
        finally:
            for f in files:
                f.close()

    def read(self, step: int) -> Tuple[Dict[str, torch.Tensor],
                                      Optional[Dict]]:
        """Every leaf of checkpoint ``step`` on the host, whole, by name,
        and the data state: each rank's block put at its place."""
        with self._open(step) as (names, get, data_state):
            return {n: get(n) for n in names}, data_state

    def restore(self, step: int, target_tree: Any, shardings: Any = None
                ) -> Tuple[Any, Optional[Dict]]:
        """Copy checkpoint ``step`` into ``target_tree``'s tensors (in
        place, on their devices) and return (the tree, the data state).

        ``shardings`` (placements matching ``target_tree`` on the current
        mesh) re-shards: each tensor takes its block of the global leaf,
        whatever mesh wrote it.  One global leaf is on the host at a time,
        as the reference's restore builds them."""
        specs = {n: sh for n, sh in flatten_with_paths(shardings)} \
            if shardings is not None else {}
        with self._open(step) as (_, get, data_state), torch.no_grad():
            for name, tgt in flatten_with_paths(target_tree):
                src = get(name)
                if name in specs:
                    src = specs[name].shard(src)
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(f"{name}: checkpoint shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(tgt.shape)}")
                tgt.copy_(src.to(tgt.dtype))
                del src
        return target_tree, data_state


def _spec_json(spec) -> List:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _assemble(leaf: Dict, files, mesh: Optional[Dict]) -> np.ndarray:
    """The global leaf from every rank's block of it (one file's whole
    leaf when the checkpoint records no placement).  A block several
    ranks held is in the file of the one that wrote it; every block must
    be in one."""
    name = leaf["name"]
    if leaf.get("spec") is None or mesh is None:
        return files[0][name]
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.rules import NamedSharding
    spec = tuple(tuple(e) if isinstance(e, list) else e
                 for e in leaf["spec"])
    sh = NamedSharding(Mesh(mesh["shape"], mesh["axes"]), spec)
    first = files[0][name]
    out = np.empty(leaf["global_shape"], dtype=first.dtype)
    blocks = set()
    for host, f in enumerate(files):
        if name in f.files:
            at = sh.index(out.shape, _coords(host, mesh))
            out[at] = f[name]
            blocks.add(tuple((s.start, s.stop) for s in at))
    if len(blocks) != math.prod(sh.parts(d) for d in range(out.ndim)):
        raise ValueError(f"{name}: the shard files hold {len(blocks)} of "
                         "its blocks, not all")
    return out


_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def reference_tree(leaves: Dict[str, Any], index: int = 0) -> Dict:
    """The ``index``-th top-level entry of a reference checkpoint (``0``
    for the parameters of a ``(params, opt_state)`` save) as the nested
    dict tree of numpy arrays the reference's ``keystr`` names describe."""
    out: Dict = {}
    for name, leaf in leaves.items():
        keys = [k if k else int(i) for k, i in _KEY.findall(name)]
        if not keys or keys[0] != index:
            continue
        node = out
        for k in keys[1:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf.numpy() if isinstance(leaf, torch.Tensor) \
            else leaf
    return out
