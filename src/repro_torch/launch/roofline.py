"""Roofline analysis of the dry-run records, on one card.

    python -m repro_torch.launch.roofline [--results DIR] [--json-out F] \
        [--step-s ARCH:SHAPE=SECONDS ...] [--table roofline|dryrun|all]

The single-card counterpart of ``repro/launch/roofline.py``.  Per cell
(one record of ``launch/dryrun.py``):

    compute term = probe FLOPs / the card's bf16 peak        [s]
    memory term  = probe bytes / the card's HBM rate         [s]

(a cell on one card has no collective term; a mesh's, the tally of
``launch/comm_analysis.py`` over the links' rate, is not added yet),
both from ``launch/hw.py``'s data sheet.  ``model_flops`` is 6 N T for train, 2 N T for prefill and 2 N per
sequence for decode, N the active parameters for MoE: the reference's
``model_flops_per_device`` at one chip, except that N leaves out an
untied input embedding table (``matmul_params``).  That table is a gather
and does no arithmetic; with it, llama3.2-3b's prefill step claimed 1.012
times the FLOPs it computes (0.39 B of 3.61 B parameters), a roofline
fraction above 1 on the card.  ``useful_compute_ratio`` is
model FLOPs over probe FLOPs (what remat replays, masking and dispatch
add), and ``roofline_fraction`` the model FLOPs per second the slower
term allows, over the peak.  Given a measured step time, ``mfu`` is the
model FLOPs per second it achieved, over the peak.

The ``roofline`` table is this module's; the ``dryrun`` table lists every
record's status, micro-batch and bytes.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import hw
from repro_torch.launch.dryrun import RESULTS


def matmul_params(cfg: ModelConfig) -> int:
    """The parameters a token's matmuls use: ``param_count`` (active ones
    for MoE) without an untied input embedding table, which is a gather
    (a tied table is the unembedding's matmul too, and counts once)."""
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model
    return n


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 N T (train), 2 N T (prefill) or 2 N per sequence (decode) for the
    whole step on the one card, N = :func:`matmul_params`."""
    return _model_flops(matmul_params(cfg), shape)


def _model_flops(n: int, shape: ShapeConfig) -> float:
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def analyze(arch: str, shape: ShapeConfig, flops: float, nbytes: float, *,
            n_params: Optional[int] = None, step_s: Optional[float] = None,
            card: hw.CardPeaks = hw.H100_SXM) -> Dict:
    """One row: the two terms, which one bounds the step, the useful
    ratio, the roofline fraction and, given ``step_s``, the MFU.
    ``n_params`` (:func:`matmul_params`) defaults to ``arch``'s
    registered config's."""
    peak = card.flops["bfloat16"]
    t_compute = flops / peak
    t_memory = nbytes / card.hbm_bytes_per_s
    t_total = max(t_compute, t_memory)
    mf = model_flops(ARCHS[arch], shape) if n_params is None \
        else _model_flops(n_params, shape)
    row = {"arch": arch, "shape": shape.name, "kind": shape.kind,
           "flops": flops, "bytes": nbytes,
           "t_compute_s": t_compute, "t_memory_s": t_memory,
           "dominant": "compute" if t_compute >= t_memory else "memory",
           "model_flops": mf,
           "useful_compute_ratio": mf / flops if flops else 0.0,
           "roofline_fraction": (mf / t_total) / peak if t_total else 0.0}
    if step_s is not None:
        row["step_s"] = step_s
        row["mfu"] = mf / step_s / peak
    return row


def record_shape(rec: Dict) -> ShapeConfig:
    """The shape a record was probed at (its sequence and batch may be a
    cut of the registry's)."""
    return ShapeConfig(rec["shape"], rec["seq_len"], rec["global_batch"],
                       rec["kind"])


def analyze_cell(rec: Dict, step_s: Optional[float] = None
                 ) -> Optional[Dict]:
    """The row of a dry-run record, or None for a record with no probe.
    The terms are against the record's card (the H100's for a CPU run)."""
    if rec.get("status") != "ok" or "flops" not in (rec.get("probe") or {}):
        return None
    p = rec["probe"]
    row = analyze(rec["arch"], record_shape(rec), p["flops"], p["bytes"],
                  n_params=rec["matmul_param_count"], step_s=step_s,
                  card=hw.PEAKS.get(rec.get("device"), hw.H100_SXM))
    row["device"] = rec.get("device")
    row["peak_bytes"] = rec.get("measured_peak_bytes")
    row["reckoned_bytes"] = rec["reckoned"]["total_bytes"]
    return row


def load_records(results_dir: Path = RESULTS) -> List[Dict]:
    return [json.loads(p.read_text())
            for p in sorted(Path(results_dir).glob("*.json"))]


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'t_comp(s)':>10s} "
           f"{'t_mem(s)':>10s} {'dominant':>9s} {'useful':>7s} "
           f"{'roofline':>9s} {'mfu':>7s} {'peak(GB)':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        mfu = f"{r['mfu']:7.2%}" if "mfu" in r else f"{'-':>7s}"
        peak = r.get("peak_bytes")
        peak = f"{peak / 1e9:9.2f}" if peak is not None else f"{'-':>9s}"
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['t_compute_s']:10.4f} "
            f"{r['t_memory_s']:10.4f} {r['dominant']:>9s} "
            f"{r['useful_compute_ratio']:7.2%} "
            f"{r['roofline_fraction']:9.2%} {mfu} {peak}")
    return "\n".join(lines)


def dryrun_table(records: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'status':>12s} {'microbatch':>10s} "
           f"{'reckoned(GB)':>12s} {'peak(GB)':>9s} {'probe(s)':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        if r["status"] == "ok":
            peak = r["measured_peak_bytes"]
            lines.append(
                f"{r['arch']:24s} {r['shape']:12s} {'ok':>12s} "
                f"{r['microbatch']:>4d} x {r['microbatches']:<3d} "
                f"{r['reckoned']['total_bytes'] / 1e9:12.2f} "
                + (f"{peak / 1e9:9.2f} " if peak is not None
                   else f"{'-':>9s} ")
                + f"{r['timing']['probe_s']:8.1f}")
        else:
            lines.append(f"{r['arch']:24s} {r['shape']:12s} "
                         f"{r['status']:>12s}")
    return "\n".join(lines)


def _step_times(specs: List[str]) -> Dict[str, float]:
    out = {}
    for spec in specs:
        cell, _, seconds = spec.partition("=")
        out[cell] = float(seconds)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--step-s", action="append", default=[],
                    help="ARCH:SHAPE=SECONDS, a measured step time (adds "
                         "the cell's mfu)")
    ap.add_argument("--table", default="roofline",
                    choices=["roofline", "dryrun", "all"])
    args = ap.parse_args(argv)
    records = load_records(Path(args.results))
    steps = _step_times(args.step_s)
    rows = [r for r in (analyze_cell(
        rec, steps.get(f"{rec['arch']}:{rec['shape']}")) for rec in records)
        if r is not None]
    if args.table in ("dryrun", "all"):
        print(dryrun_table(records))
    if args.table in ("roofline", "all"):
        print(format_table(rows))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
