"""Async checkpointing onto one device, in the reference's on-disk layout.

Port of ``repro/checkpoint/ckpt.py``.  One directory per step:

    <dir>/step_<n>/
        manifest.json        — leaf names, shapes, dtypes, step metadata
        shard_<host>.npz     — this host's leaves
        data_state.json      — data-stream position

* async: ``save`` copies every leaf to host memory (the blocking part,
  device -> host) and a background thread writes the files;
* atomic publish: files go to ``step_<n>.tmp``, renamed once the manifest
  is written, so a crash mid-save never leaves a half checkpoint that
  ``all_steps`` would list;
* garbage collection: the last ``keep`` checkpoints stay.

A tree is a nested dict / list / tuple of tensors; leaf names are the
reference's ``jax.tree_util.keystr`` of their path (``[0]['embed']``), so
the manifests read alike.  bfloat16 leaves, which npz cannot hold, are
stored as their uint16 bits and the manifest records ``bfloat16``.

Restore is onto one device: every leaf is read whole and copied into the
target tree's tensors, in place.  The reference's elastic restore, which
re-shards each leaf onto the current mesh (a run saved on N hosts resuming
on M), belongs to the pod layer and raises ``NotImplementedError`` (ROADMAP
item 11).  :func:`reference_tree` reads a checkpoint the reference wrote
back into its nested tree, from which ``convert.params_from_numpy``
builds the port's model.
"""

from __future__ import annotations

import json
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
    return t.cpu().numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype)))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_id: int = 0, n_hosts: int = 1):
        if n_hosts != 1 or host_id != 0:
            raise NotImplementedError(
                "multi-host checkpoints belong to the pod layer, out of scope "
                "on one card (ROADMAP item 11)")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, data_state: Optional[Dict] = None,
             *, blocking: bool = False) -> None:
        """Copy to host memory now; write the files in the background."""
        self.wait()
        snap = [(name, *_to_numpy(leaf))
                for name, leaf in flatten_with_paths(tree)]

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / f"shard_{self.host_id}.npz",
                     **{n: a for n, a, _ in snap})
            manifest = {
                "step": step,
                "time": time.time(),
                "n_hosts": self.n_hosts,
                "treedef": f"{len(snap)} leaves",
                "leaves": [
                    {"name": n, "global_shape": list(a.shape), "dtype": dt,
                     "shard_shape": list(a.shape)}
                    for n, a, dt in snap
                ],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if data_state is not None:
                (tmp / "data_state.json").write_text(json.dumps(data_state))
            tmp.rename(final)
            self._gc()

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def read(self, step: int) -> Tuple[Dict[str, torch.Tensor],
                                      Optional[Dict]]:
        """Every leaf of checkpoint ``step`` on the host, by name, and the
        data state."""
        cdir = self.dir / f"step_{step}"
        manifest = json.loads((cdir / "manifest.json").read_text())
        if manifest["n_hosts"] != 1:
            raise NotImplementedError(
                f"checkpoint {cdir} was written by {manifest['n_hosts']} "
                "hosts; re-sharding it belongs to the pod layer (ROADMAP "
                "item 11)")
        with np.load(cdir / "shard_0.npz") as shard:
            leaves = {m["name"]: _from_numpy(shard[m["name"]], m["dtype"])
                      for m in manifest["leaves"]}
        ds_path = cdir / "data_state.json"
        data_state = json.loads(ds_path.read_text()) if ds_path.exists() \
            else None
        return leaves, data_state

    def restore(self, step: int, target_tree: Any, shardings: Any = None
                ) -> Tuple[Any, Optional[Dict]]:
        """Copy checkpoint ``step`` into ``target_tree``'s tensors (in
        place, on their devices) and return (the tree, the data state).

        ``shardings`` is the reference's elastic re-shard onto a mesh,
        which raises (ROADMAP item 11)."""
        if shardings is not None:
            raise NotImplementedError(
                "restoring onto a mesh (elastic re-shard) belongs to the "
                "pod layer, out of scope on one card (ROADMAP item 11)")
        leaves, data_state = self.read(step)
        with torch.no_grad():
            for name, tgt in flatten_with_paths(target_tree):
                if name not in leaves:
                    raise KeyError(f"{name} missing from checkpoint")
                src = leaves[name]
                if tuple(src.shape) != tuple(tgt.shape):
                    raise ValueError(f"{name}: checkpoint shape "
                                     f"{tuple(src.shape)} != "
                                     f"{tuple(tgt.shape)}")
                tgt.copy_(src.to(tgt.dtype))
        return target_tree, data_state


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
