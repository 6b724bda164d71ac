"""Read the two ends that a cell's limits are set between, on the card, at
the cell's own size.

    python chipbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--out chiprun_out/control.jsonl]

For every seed of ``--seeds``: the program's first train steps against
the float32 reference's (the lower reading of each number).  For every
seed of ``--control-seeds`` also: the control, the reference computed with
its weight products in float8 (the step down from the bfloat16 the
configurations compute in), put in the program's place; and the fault of
half the batch left out, the mean taken over the rest, in the reference
put in the program's place.  The fault of a step that leaves the state
unchanged needs no run: its gradient and change norms are 0, so those
numbers read 1.  One JSON line a reading, on standard output and in
``--out``.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chipbench import correct, harness  # noqa: E402


def _emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()


def main(argv=None, device: str = "cuda", root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, root)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        out = open(args.out, "a")
    try:
        for seed in dict.fromkeys(seeds + controls):
            t = time.perf_counter()
            prog = harness.Program(cell, seed, device)
            readings = prog.first_steps(cell.workload["followed_steps"])
            t_prog = time.perf_counter() - t
            prog = None
            harness.free()
            t = time.perf_counter()
            ref = harness.reference_readings(cell, seed, device)
            t_ref = time.perf_counter() - t
            rows = {"program": readings}
            if seed in controls:
                rows["control_float8"] = harness.reference_readings(
                    cell, seed, device, precision="float8")
                rows["fault_half_batch"] = harness.reference_readings(
                    cell, seed, device, rows=cell.rows // 2)
            for kind, got in rows.items():
                found = correct.numbers(got, ref)
                _emit(out, {"cell": cell.name, "seed": seed, "kind": kind,
                            "numbers": {k: v for k, (v, _) in found.items()},
                            "worst": {k: w for k, (_, w) in found.items()},
                            "losses": got["losses"],
                            "ref_losses": ref["losses"],
                            "program_s": t_prog, "reference_s": t_ref})
            harness.free()
    finally:
        if out is not None:
            out.close()
    found = harness.banned_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
