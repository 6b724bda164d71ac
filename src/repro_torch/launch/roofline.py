"""Roofline analysis of the dry-run records, on one card.

    python -m repro_torch.launch.roofline [--results DIR] [--json-out F] \
        [--step-s ARCH:SHAPE=SECONDS ...] [--table roofline|dryrun|all]

The counterpart of ``repro/launch/roofline.py`` on the H100.  Per cell
(one record of ``launch/dryrun.py``), per rank:

    compute term    = probe FLOPs / the card's bf16 peak           [s]
    memory term     = probe bytes / the card's HBM rate            [s]
    collective term = collective bytes / the card's NVLink rate    [s]

all from ``launch/hw.py``'s data sheet.  A one-card record has no
collective term (its row has the two terms only); a mesh record
(``dryrun.run_mesh_cell``) carries its rank's counted FLOPs and bytes and
the collective bytes of its tally (``launch/comm_analysis.py``:
``collective_bytes``, the larger of operand and result bytes), and
``dominant`` is the slowest of the three, as the reference takes it.
``model_flops`` is 6 N T for train, 2 N T for prefill and 2 N per
sequence for decode, N the active parameters for MoE, and
``model_flops_per_dev`` that over the record's chips: the reference's
``model_flops_per_device``, except that N leaves out an
untied input embedding table (``matmul_params``).  That table is a gather
and does no arithmetic; with it, llama3.2-3b's prefill step claimed 1.012
times the FLOPs it computes (0.39 B of 3.61 B parameters), a roofline
fraction above 1 on the card.  ``useful_compute_ratio`` is
model FLOPs over probe FLOPs (what remat replays, masking and dispatch
add), and ``roofline_fraction`` the model FLOPs per second the slower
term allows, over the peak.  Given a measured step time, ``mfu`` is the
model FLOPs per second it achieved, over the peak.

The ``roofline`` table is this module's; the ``dryrun`` tables list
every record's status, micro-batch and bytes, the single-pod records
(one card, or a (data, model) mesh) apart from the multi-pod ones (a
(pod, data, model) mesh), as ``results/gen_tables.py`` prints them.
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
            card: hw.CardPeaks = hw.H100_SXM,
            collective_bytes: Optional[float] = None, chips: int = 1
            ) -> Dict:
    """One row: the terms, which one bounds the step, the useful ratio,
    the roofline fraction and, given ``step_s``, the MFU.  ``n_params``
    (:func:`matmul_params`) defaults to ``arch``'s registered config's.
    Given a rank's ``collective_bytes`` (a mesh of ``chips`` cards, the
    other numbers a rank's too), the row adds the collective term and
    the model FLOPs a device, and takes the slowest of the three terms."""
    peak = card.flops["bfloat16"]
    t_compute = flops / peak
    t_memory = nbytes / card.hbm_bytes_per_s
    terms = {"compute": t_compute, "memory": t_memory}
    if collective_bytes is not None:
        terms["collective"] = collective_bytes / card.link_bytes_per_s
    t_total = max(terms.values())
    mf = model_flops(ARCHS[arch], shape) if n_params is None \
        else _model_flops(n_params, shape)
    mf_dev = mf / chips
    row = {"arch": arch, "shape": shape.name, "kind": shape.kind,
           "flops": flops, "bytes": nbytes,
           "t_compute_s": t_compute, "t_memory_s": t_memory,
           "dominant": max(terms, key=terms.get),
           "model_flops": mf,
           "useful_compute_ratio": mf_dev / flops if flops else 0.0,
           "roofline_fraction": (mf_dev / t_total) / peak if t_total
           else 0.0}
    if collective_bytes is not None:
        row.update(chips=chips, collective_bytes=collective_bytes,
                   t_collective_s=terms["collective"],
                   model_flops_per_dev=mf_dev)
    if step_s is not None:
        row["step_s"] = step_s
        row["mfu"] = mf_dev / step_s / peak
    return row


def record_shape(rec: Dict) -> ShapeConfig:
    """The shape a record was probed at (its sequence and batch may be a
    cut of the registry's)."""
    return ShapeConfig(rec["shape"], rec["seq_len"], rec["global_batch"],
                       rec["kind"])


def analyze_cell(rec: Dict, step_s: Optional[float] = None
                 ) -> Optional[Dict]:
    """The row of a dry-run record, or None for a record with no probe.
    The terms are against the record's card (the H100's for a CPU run).
    A mesh record (one with ``chips``) adds its collective term."""
    if rec.get("status") != "ok" or "flops" not in (rec.get("probe") or {}):
        return None
    p = rec["probe"]
    mesh = "chips" in rec
    row = analyze(rec["arch"], record_shape(rec), p["flops"], p["bytes"],
                  n_params=rec["matmul_param_count"], step_s=step_s,
                  card=hw.PEAKS.get(rec.get("device"), hw.H100_SXM),
                  collective_bytes=(rec["collectives"]["collective_bytes"]
                                    if mesh else None),
                  chips=rec.get("chips", 1))
    row["device"] = rec.get("device")
    row["peak_bytes"] = rec.get("measured_peak_bytes")
    if mesh:
        row["mesh"] = rec.get("mesh_shape", rec["mesh"])
    else:
        row["reckoned_bytes"] = rec["reckoned"]["total_bytes"]
    return row


def load_records(results_dir: Path = RESULTS) -> List[Dict]:
    """Every dry-run record (``<arch>__<shape>__<mesh>.json``) in
    ``results_dir``; other JSON files there (the multi-pod probe's) are
    not records."""
    return [json.loads(p.read_text())
            for p in sorted(Path(results_dir).glob("*__*__*.json"))]


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':6s} {'t_comp(s)':>10s} "
           f"{'t_mem(s)':>10s} {'t_coll(s)':>10s} {'dominant':>10s} "
           f"{'useful':>7s} {'roofline':>9s} {'mfu':>7s} {'peak(GB)':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        mfu = f"{r['mfu']:7.2%}" if "mfu" in r else f"{'-':>7s}"
        peak = r.get("peak_bytes")
        peak = f"{peak / 1e9:9.2f}" if peak is not None else f"{'-':>9s}"
        coll = f"{r['t_collective_s']:10.4f}" if "t_collective_s" in r \
            else f"{'-':>10s}"
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r.get('mesh', '1gpu'):6s} "
            f"{r['t_compute_s']:10.4f} "
            f"{r['t_memory_s']:10.4f} {coll} {r['dominant']:>10s} "
            f"{r['useful_compute_ratio']:7.2%} "
            f"{r['roofline_fraction']:9.2%} {mfu} {peak}")
    return "\n".join(lines)


def dryrun_table(records: List[Dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'status':>12s} {'microbatch':>10s} "
           f"{'reckoned(GB)':>12s} {'peak(GB)':>9s} {'probe(s)':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        if r["status"] == "ok" and "chips" in r:        # a mesh record
            peak = r["measured_peak_bytes"]
            lines.append(
                f"{r['arch']:24s} {r['shape']:12s} "
                f"{'ok ' + r.get('mesh_shape', r['mesh']):>12s} "
                f"{r['microbatches']:>10d} {'-':>12s} "
                + (f"{peak / 1e9:9.2f} " if peak is not None
                   else f"{'-':>9s} ") + f"{r['step_s']:8.1f}")
        elif r["status"] == "ok":
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
        multi = [r for r in records if r.get("mesh") == "multipod"]
        print("### single-pod (one card, or a (data, model) mesh)\n")
        print(dryrun_table([r for r in records if r not in multi]))
        print("\n### multi-pod (a (pod, data, model) mesh)\n")
        print(dryrun_table(multi))
    if args.table in ("roofline", "all"):
        print(format_table(rows))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=2))


if __name__ == "__main__":
    main()
