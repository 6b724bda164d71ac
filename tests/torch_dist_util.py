"""Run a function of ``tests/torch_dist_cases.py`` on the ranks of a gloo
world on the CPU, under a hard time limit.

``run_ranks(case, outdir, world=4, timeout=...)`` starts one child
process (``subprocess.run`` with ``timeout``, as
``tests/test_distribution.py:_run`` runs its JAX meshes), which spawns
``world`` ranks with ``torch.multiprocessing``; each joins the world
through ``init_method="file://..."`` (no network) with a 60 s collective
timeout and calls ``torch_dist_cases.<case>(rank, world, outdir, **kw)``.
The cases read their inputs from and write their results to ``outdir``.
A deadlocked rank fails the child's limit instead of hanging the suite.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import uuid
from pathlib import Path

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent


def run_ranks(case: str, outdir, *, world: int = 4, timeout: int = 240,
              join: bool = True, **kw) -> str:
    """Run ``case`` on ``world`` ranks; with ``join=False`` the ranks do
    not join a world first (the case does, and gets ``rendezvous=``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(TESTS)])
    env.setdefault("OMP_NUM_THREADS", "1")
    res = subprocess.run(
        [sys.executable, str(Path(__file__)), case, str(outdir), str(world),
         json.dumps(kw), "1" if join else "0"], capture_output=True, text=True, timeout=timeout,
        env=env, cwd=ROOT)
    assert res.returncode == 0, \
        f"STDOUT:\n{res.stdout[-4000:]}\nSTDERR:\n{res.stderr[-8000:]}"
    return res.stdout


def _entry(rank: int, case: str, outdir: str, world: int, kw: dict,
           rendezvous: str, join: bool) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import torch_dist_cases
    fn = getattr(torch_dist_cases, case)
    if not join:
        fn(rank, world, Path(outdir), rendezvous=rendezvous, **kw)
        return
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        fn(rank, world, Path(outdir), **kw)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    case, outdir, world, kw = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        json.loads(sys.argv[4])
    rendezvous = str(Path(outdir) / f"rendezvous_{uuid.uuid4().hex}")
    mp.spawn(_entry, args=(case, outdir, world, kw, rendezvous,
                           sys.argv[5] == "1"), nprocs=world, join=True)
