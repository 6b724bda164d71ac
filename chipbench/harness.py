"""One run of one training cell of the port (``repro_torch``).

Set-up builds the port's train step (``train/step.py:make_train_step``),
its model and its AdamW state on the card, loads the benchmark's own
weights drawn from the seed (``chipbench/weights.py``) and drives the
step through its first steps on batches drawn from the seed, reading what
the comparison needs.  Those steps compile and warm every shape the
window uses.  The window then drives the same step, on the same objects,
as ``Trainer.run`` does: the batch to the card, the step, the loss read
as a float (which waits for the step).  With ``--trace 1`` four more steps
run under the profiler after the window, which they would slow, and the
per-layer metrics and the breakdown are read from them.  Then the program
is freed and the plain reference (``chipbench/reference/<family>.py``)
follows the same first steps from the same weights; ``correct.py``
decides.

Everything of one cell is data: ``BENCHMARK.json`` names the cell, its
configuration and its traffic, ``chipbench/workloads/<cell>.json`` the
batch and the limits, ``chipbench/configs/<config>.json`` the widths,
``chipbench/traffic/<traffic>.json`` the stream; a per-layer metric is
``chipbench/metrics/<metric>.py``'s ``read(ctx)``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from chipbench import correct, trace, traffic, weights
from chipbench.reference import common

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")
TRACED_STEPS = 3     # steps whose card time the per-layer metrics read


# ---------------------------------------------------------------------------
# the cell's data
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    bench: Dict
    entry: Dict          # the cell's entry in BENCHMARK.json
    workload: Dict       # chipbench/workloads/<cell>.json
    config: Dict         # the configuration file
    traffic: Dict        # chipbench/traffic/<traffic>.json

    @property
    def rows(self) -> int:
        return self.workload["sequences_per_step"]

    @property
    def micro(self) -> int:
        return self.workload["microbatches"]

    @property
    def seq_len(self) -> int:
        return self.traffic["seq_len"]

    def applies(self, metric: Dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = root / "chipbench"
    workload = json.loads((bench_dir / "workloads" / f"{name}.json")
                          .read_text())
    return Cell(name, bench, entry, workload,
                json.loads((root / conf["file"]).read_text()),
                json.loads((bench_dir / "traffic" / f"{entry['traffic']}"
                            ".json").read_text()))


def reference_module(cell: Cell):
    return importlib.import_module(
        f"chipbench.reference.{cell.config['family']}")


def batch_on(cell: Cell, seed: int, step: int, device, rows=None
             ) -> Dict[str, torch.Tensor]:
    host = traffic.batch(cell.traffic, seed, step, rows or cell.rows,
                         cell.config["vocab"])
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

KERNELS = {"flash": "repro_torch.kernels.flash_attention.kernel",
           "swiglu": "repro_torch.kernels.fused_swiglu.kernel"}


def launches() -> Dict[str, int]:
    """The program's kernel launch counters."""
    return {k: importlib.import_module(m).LAUNCHES
            for k, m in KERNELS.items()}


class Program:
    """The port's train step with its model and AdamW state, built once;
    ``step(i)`` runs step ``i`` as ``Trainer.run`` does."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.configs.base import ModelConfig, ShapeConfig
        from repro_torch.models.model import build_model
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.train import step as step_mod

        self.cell, self.seed, self.device = cell, seed, device
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        model = build_model(ModelConfig(**{k: v for k, v in
                                           cell.config.items()
                                           if k in fields}))
        hp = cell.config["optimizer"]
        self.b1 = hp["b1"]
        shape = ShapeConfig(cell.name, cell.seq_len, cell.rows, "train")
        self.bundle = step_mod.make_train_step(
            model, make_optimizer("adamw", **hp), shape,
            microbatches=cell.micro)
        self.params = model.init(0, device=device, trainable=True)
        self.layout = reference_module(cell).layout(cell.config)
        self.named = dict(self.params.named_parameters())
        weights.load_into(self.named, self.layout, seed, device)
        self.opt_state = self.bundle.init_state(self.params)

    def step(self, i: int) -> float:
        with record_function("bench.batch_to_card"):
            batch = batch_on(self.cell, self.seed, i, self.device)
        with record_function("bench.train_step"):
            self.params, self.opt_state, metrics = self.bundle.fn(
                self.params, self.opt_state, batch)
        with record_function("bench.read_loss"):
            return float(metrics["loss"])

    def first_steps(self, n: int) -> Dict:
        """Steps 0..n-1 with the readings the comparison needs."""
        losses, first = [], {}
        for i in range(n):
            losses.append(self.step(i))
            if i == 0:
                with torch.no_grad():
                    first = {name: float(torch.linalg.vector_norm(
                        self.opt_state["mu"][name]["m"])) / (1 - self.b1)
                        for name in self.named}
        return {"losses": losses, "first_grad_norms": first,
                "change_norms": weights.change_norms(
                    self.named, self.layout, self.seed, self.device)}

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in _leaves(self.opt_state))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def reference_readings(cell: Cell, seed: int, device, *,
                       precision: str = "float32", rows=None) -> Dict:
    """The reference's readings over the first ``followed_steps`` steps:
    in ``precision`` (the control: float8), on ``rows`` of each batch (a
    fault: half of them, the mean over the rest)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod = reference_module(cell)
    layout = mod.layout(cell.config)
    params = weights.materialise(layout, seed, device)
    n = cell.workload["followed_steps"]
    batches = [batch_on(cell, seed, i, device, rows) for i in range(n)]
    micro = min(cell.micro, rows or cell.rows)
    out = common.follow(mod.loss, cell.config, params, batches, micro,
                        cell.config["optimizer"], common.Matmul(precision))
    out["change_norms"] = weights.change_norms(params, layout, seed, device)
    return out


def free() -> None:
    """Return what the freed program held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (``repro_torch`` is not ``repro``: names compare whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _metric_reader(name: str) -> Callable:
    return importlib.import_module(f"chipbench.metrics.{name}").read


def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda") -> int:
    """One run; prints the result line last on standard output and the
    compared numbers last on standard error.  Returns the exit code."""
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prog = Program(cell, seed, device)
    n_first = cell.workload["followed_steps"]
    readings = prog.first_steps(n_first)
    sync()

    # ---- the window -------------------------------------------------------
    losses, step_s = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    t_last, i = t0, n_first
    while True:
        loss = prog.step(i)
        t = time.perf_counter()
        i += 1
        if t > deadline:
            break
        losses.append(loss)
        step_s.append(t - t_last)
        t_last = t
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        print(f"max_memory_reserved {torch.cuda.max_memory_reserved()}",
              file=sys.stderr)
    done = len(losses)
    if done == 0:
        print(f"no step completed within {seconds} s", file=sys.stderr)
        return 1
    window_s = t_last - t0
    tokens = cell.rows * cell.seq_len
    card = torch.cuda.get_device_name(0) if cuda else "cpu"
    measured = {"train_tokens_per_s": done * tokens / window_s,
                "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
    ctx = {"config": cell.config, "seq_len": cell.seq_len,
           "sequences": cell.rows, "microbatches": cell.micro,
           "chips": cell.entry["chips"], "card": card, "cuda": cuda,
           "steps_done": done, "window_s": window_s,
           "steps_traced": TRACED_STEPS,
           "optim_state_bytes": prog.state_bytes()}

    # ---- traced steps, after the window ------------------------------------
    # TRACED_STEPS steps with only the card's activity recorded (the host's
    # recording would slow the host's side of a step and open idle gaps
    # that an untraced step does not have): busy time, kernel times,
    # launches and the checkpoint's regions.  Then one step with the
    # host's operations recorded too, only to name what the host did in
    # the card's gaps.
    t_read = time.perf_counter()
    card_only = named = None
    if traced:
        from repro_torch.core import remat
        before = launches()
        sync()
        with trace.profiled(cuda, host=not cuda) as prof, \
                remat.observe_regions() as seen:
            t = time.perf_counter()
            for _ in range(TRACED_STEPS):
                prog.step(i)
                i += 1
            sync()
            traced_s = time.perf_counter() - t
        ctx["launches"] = {k: v - before[k] for k, v in launches().items()}
        ctx["regions"] = list(seen)
        card_only = trace.card_time(prof, traced_s)
        print(f"traced step: launches {ctx['launches']}, device s by kind "
              f"{trace.by_kind(card_only['kernels'])}", file=sys.stderr)
        with trace.profiled(cuda, host=True) as prof:
            with record_function(trace.WINDOW_SPAN):
                prog.step(i)
                sync()
        named = trace.idle_gaps(prof)
        del prof
    ctx["trace"] = card_only
    t_read = time.perf_counter() - t_read
    prog = None
    free()

    # ---- the comparison ---------------------------------------------------
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    t_ref = time.perf_counter() - t_ref
    ok, checks, lines = correct.judge(readings, ref,
                                      cell.workload["limits"])
    ok = ok and all(math.isfinite(v) for v in losses)

    # ---- the result ---------------------------------------------------------
    metrics = {}
    which = cell.bench["per_layer"] if traced else cell.bench["end_to_end"]
    for m in which:
        if not cell.applies(m):
            continue
        value = _metric_reader(m["name"])(ctx) if traced \
            else measured[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok, "attempted": done,
              "failed": sum(not math.isfinite(v) for v in losses),
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": card,
                         "count": cell.entry["chips"],
                         "memory_peak_bytes": peak}}
    if traced:
        result["device"].update(busy_s=card_only["busy_s"],
                                window_s=card_only["window_s"])
        result["breakdown"] = {"device_ops": card_only["device_ops"],
                               "idle_gaps": named}
    result["checks"] = checks
    found = banned_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    print(f"window: {done} steps completed in {window_s!r} s, each "
          f"{step_s}; losses {losses}; set-up {setup_s!r} s, traced "
          f"steps and their reading {t_read!r} s, reference {t_ref!r} s",
          file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None, *, t_start: Optional[float] = None,
         device: Optional[str] = None, root: Path = ROOT) -> int:
    """``run.py``'s command line.  ``device`` "cpu" skips the look for a
    card (tests drive the rest of a run at a small size)."""
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.entry["chips"]:
            print(f"{cell.name} needs {cell.entry['chips']} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        if cell.entry["chips"] != 1:
            print("only one-card cells are run", file=sys.stderr)
            return 2
        device = "cuda"
    return run(cell, args.seed, args.seconds, bool(args.trace), t_start,
               device)
