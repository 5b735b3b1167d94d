"""Seed-swept experiment runner: ExperimentSpec → aggregate report.

Fans an :class:`~repro_torch.api.specs.ExperimentSpec` out over its
(regime × policy × migration) grid × seeds with multiprocessing, then
aggregates every numeric metric per grid cell into mean ± 95% CI
(Student-t half-width over the seed sample).  The report is a single JSON
document and is *deterministic*: rows carry no wall-clock fields, jobs are
dispatched and re-assembled in grid order, and aggregate floats are rounded
— two runs of the same spec produce byte-identical reports, so the report
itself is a CI-gateable artifact.

This is the seed-swept evaluation harness: tail statistics like
max interruption duration are noisy at a single seed; comparative claims
(HLEM-VMP vs First-Fit, gradient-aware migration vs none) become
mean ± CI over >= 20 seeds per cell, from one spec file:

    exp = ExperimentSpec.load("examples/specs/migration_sweep.json")
    report = run_experiment(exp)
    write_report(report, "results/migration_sweep.json")
"""
from __future__ import annotations

import json
import math
import multiprocessing
import os
import sys
import time
from typing import Dict, List, Optional, Set, Tuple

from .build import resolve_horizon, run_one
from ..obs.manifest import cuda_device_name, run_manifest
from .specs import ExperimentSpec, RunSpec

#: two-sided 95% Student-t critical values by degrees of freedom (n - 1);
#: beyond the table the normal limit 1.96 is used
_T95 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131, 16: 2.120, 17: 2.110, 18: 2.101,
        19: 2.093, 20: 2.086, 21: 2.080, 22: 2.074, 23: 2.069, 24: 2.064,
        25: 2.060, 26: 2.056, 27: 2.052, 28: 2.048, 29: 2.045, 30: 2.042}

_ID_KEYS = ("policy", "regime", "migration", "seed")


def t_crit95(df: int) -> float:
    if df < 1:
        return float("nan")
    if df in _T95:
        return _T95[df]
    # beyond the table: closed-form approximation t ~ 1.96 + 2.4/df
    # (within ~0.2% of the true quantile for df > 30, continuous at the
    # table boundary, converging to the normal limit)
    return 1.96 + 2.4 / df


def mean_ci95(values: List[float]) -> Dict[str, float]:
    """Mean and 95% CI half-width (t-distribution) of a seed sample."""
    n = len(values)
    mean = sum(values) / n
    if n < 2:
        return {"mean": round(mean, 6), "ci95": 0.0,
                "min": round(min(values), 6), "max": round(max(values), 6),
                "n": n}
    var = sum((v - mean) ** 2 for v in values) / (n - 1)
    half = t_crit95(n - 1) * math.sqrt(var / n)
    return {"mean": round(mean, 6), "ci95": round(half, 6),
            "min": round(min(values), 6), "max": round(max(values), 6),
            "n": n}


def aggregate_rows(rows: List[dict]) -> Dict[str, Dict[str, float]]:
    """mean ± CI for every numeric metric shared by the cell's rows."""
    out: Dict[str, Dict[str, float]] = {}
    for key in rows[0]:
        if key in _ID_KEYS:
            continue
        vals = [r[key] for r in rows]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals):
            out[key] = mean_ci95([float(v) for v in vals])
    return out


def _run_job(job) -> Tuple[dict, Optional[str]]:
    """One run's row, and the CUDA device its process used (None where
    the run never initialised CUDA), for the report's manifest."""
    spec_dict, seed, until = job
    row = run_one(RunSpec.from_dict(spec_dict), seed, until=until)
    return row, cuda_device_name()


def _report_cell(exp: ExperimentSpec, cell: RunSpec,
                 cell_rows: List[dict]) -> dict:
    out = {
        "regime": cell.scenario.regime,
        "policy": cell.policy.name,
        "migration": cell.migration.policy,
        "n_seeds": len(exp.seeds),
        "metrics": aggregate_rows(cell_rows),
        "rows": cell_rows,
    }
    # extra grid axes identify their cells; inert axes add no keys, so
    # reports without those axes stay byte-identical
    if exp.bids is not None:
        # full spec, not just the strategy name — two BidSpecs may share a
        # strategy and differ only in params
        out["bid"] = (cell.scenario.bid.to_dict()
                      if cell.scenario.bid is not None else None)
    if exp.workload_grid:
        out["workload_params"] = {
            k: cell.scenario.workload_params[k] for k in exp.workload_grid}
    if exp.fleets is not None:
        # full spec (None = the per-VM baseline cell) — two FleetSpecs may
        # share a strategy and differ only in ladder/weights params
        out["fleet"] = (cell.fleet.to_dict()
                        if cell.fleet is not None else None)
    if exp.autoscales is not None:
        # full spec (None = the fixed-capacity baseline cell) — two
        # AutoscaleSpecs may share a policy and differ only in params
        out["autoscale"] = (cell.autoscale.to_dict()
                            if cell.autoscale is not None else None)
    return out


def _assemble_report(exp: ExperimentSpec, horizon, n_runs: int,
                     report_cells: List[dict]) -> dict:
    return {
        "name": exp.name,
        "experiment": exp.to_dict(),
        "horizon": horizon,
        "n_runs": n_runs,
        "cells": report_cells,
    }


def _load_resume_cells(path: str, exp: ExperimentSpec,
                       horizon) -> List[dict]:
    """Completed report cells from a partial (or final) report at ``path``,
    when it matches this experiment + horizon; ``[]`` otherwise.  Partial
    files only ever contain whole cells, appended in grid order, so the
    loaded list is always a reusable prefix of the grid."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    same = (doc.get("experiment") == json.loads(json.dumps(exp.to_dict()))
            and doc.get("horizon") == horizon)
    return list(doc.get("cells", [])) if same else []


def _atomic_write(doc: dict, path: str) -> str:
    """Write ``doc`` as JSON via a temp file + ``os.replace``, so readers
    (and a crash-resumed rerun) never see a half-written report."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def run_experiment(exp: ExperimentSpec, processes: Optional[int] = None,
                   until: Optional[float] = None,
                   progress: bool = False,
                   report_path: Optional[str] = None,
                   resume: bool = True,
                   manifest: bool = False) -> dict:
    """Run the full grid × seed fan-out and aggregate per cell.

    ``processes``: worker count for the multiprocessing pool; ``0`` or ``1``
    runs serially in-process (reports are identical either way — rows are
    re-assembled in grid order).  ``until`` overrides every run's horizon
    (e.g. for smoke sweeps).

    ``report_path``: incremental report writing — the report JSON is
    re-written (atomic temp-file + rename) after **every completed cell**,
    with ``"partial": true`` until the grid is done, so long 100+-seed
    sweeps are inspectable mid-run.  With ``resume=True`` (default) an
    existing report at that path whose experiment + horizon match is
    treated as a crash checkpoint: its completed cells are reused verbatim
    and only the remaining cells run — the finished report is byte-identical
    to an uninterrupted run.

    ``progress``: per-job progress lines on **stderr** (stdout stays pure
    for ``--json`` consumers) with per-cell wall time and a simple ETA
    extrapolated from this session's completed jobs.

    ``manifest``: attach a :func:`repro_torch.obs.manifest.run_manifest` block
    (spec hash, git SHA, package versions, wall duration) to the report.
    Off by default — the manifest carries wall-clock fields, and the
    *default* report is byte-deterministic (two runs of the same spec are
    identical artifacts; the determinism tests rely on it).  The CLI turns
    it on for every report it writes.  Resume ignores the block."""
    t_session = time.perf_counter()  # detlint: disable=no-wallclock — stderr ETA only, never in the report
    cells = exp.cells()
    n_seeds = len(exp.seeds)
    horizon = until if until is not None else resolve_horizon(exp.scenario)
    report_cells: List[dict] = []
    if report_path and resume:
        report_cells = _load_resume_cells(report_path, exp, horizon)[
            : len(cells)]
    n_done = len(report_cells)
    if n_done:
        # always announce reuse (stderr, so --json stdout stays pure):
        # resumed cells reflect the code that produced the checkpoint —
        # pass resume=False (CLI: --fresh) after changing the simulator
        print(f"# sweep resume: {n_done}/{len(cells)} cells reused from "
              f"{report_path}", file=sys.stderr, flush=True)
    n_runs = len(cells) * n_seeds
    # flat job list for the remaining cells, in grid-major order
    # (cell k's seeds, cell k+1's seeds, …)
    jobs = [(cell.to_dict(), seed, until)
            for cell in cells[n_done:] for seed in exp.seeds]

    pending: List[dict] = []
    done_jobs = n_done * n_seeds
    session_jobs = 0                      # jobs actually run this session
    t_cell = time.perf_counter()          # detlint: disable=no-wallclock — stderr ETA only, never in the report

    devices: Set[str] = set()

    def _collect(result: Tuple[dict, Optional[str]]) -> None:
        nonlocal done_jobs, session_jobs, t_cell
        row, device = result
        if device is not None:
            devices.add(device)
        pending.append(row)
        done_jobs += 1
        session_jobs += 1
        if progress:
            # ETA from this session's throughput only — resumed cells were
            # free and must not make the estimate optimistic
            elapsed = time.perf_counter() - t_session  # detlint: disable=no-wallclock — stderr ETA only
            rate = elapsed / session_jobs
            eta = rate * (n_runs - done_jobs)
            print(f"# sweep {done_jobs}/{n_runs}  "
                  f"avg {rate:.2f}s/run  eta {eta:.0f}s",
                  file=sys.stderr, flush=True)
        if len(pending) == n_seeds:       # one whole cell completed
            report_cells.append(
                _report_cell(exp, cells[len(report_cells)], pending[:]))
            pending.clear()
            now = time.perf_counter()  # detlint: disable=no-wallclock — stderr ETA only
            if progress:
                print(f"# sweep cell {len(report_cells)}/{len(cells)} "
                      f"done in {now - t_cell:.2f}s",
                      file=sys.stderr, flush=True)
            t_cell = now
            if report_path and len(report_cells) < len(cells):
                partial = _assemble_report(exp, horizon, n_runs,
                                           report_cells)
                partial["partial"] = True
                _atomic_write(partial, report_path)

    if processes is None:
        processes = min(os.cpu_count() or 1, max(len(jobs), 1))
    if processes > 1 and len(jobs) > 1:
        # prefer fork so registry entries added at runtime (e.g. a custom
        # policy registered in the caller's __main__) survive into workers;
        # under spawn, custom plugins must be registered at import time of
        # an importable module.  A forked worker cannot use CUDA if this
        # process initialised it first: the launcher's parent never does
        try:
            ctx = multiprocessing.get_context("fork")
        except ValueError:  # fork unavailable (e.g. Windows)
            ctx = multiprocessing.get_context()
        with ctx.Pool(processes) as pool:
            # imap preserves job order, so the report stays deterministic
            # and cells complete strictly in grid order
            for result in pool.imap(_run_job, jobs, chunksize=1):
                _collect(result)
    else:
        for job in jobs:
            _collect(_run_job(job))

    report = _assemble_report(exp, horizon, n_runs, report_cells)
    if manifest:
        report["manifest"] = run_manifest(
            spec_dict=exp.to_dict(), seed=list(exp.seeds),
            duration_s=time.perf_counter() - t_session,  # detlint: disable=no-wallclock — manifest is opt-in wall metadata
            extra={"resumed_cells": n_done,
                   "device": ", ".join(sorted(devices)) or None})
    if report_path:
        _atomic_write(report, report_path)
    return report


def write_report(report: dict, path: str) -> str:
    return _atomic_write(report, path)


def format_report(report: dict) -> str:
    """Human-readable mean ± CI table (the sweep CLI's default output)."""
    fleet_axis = any("fleet" in c for c in report["cells"])
    lines = [
        f"sweep: {report['name']}  "
        f"({report['n_runs']} runs, {report['cells'][0]['n_seeds']} seeds "
        f"per cell, horizon={report['horizon']})",
        f"{'regime':11s} {'policy':18s} {'migration':15s} "
        + (f"{'fleet':12s} " if fleet_axis else "")
        + f"{'interruptions':>20s} {'max_intr_s':>18s} {'migr':>12s} "
        f"{'spot_cost':>17s}"
        + (f" {'below_tgt_s':>18s} {'recovery_s':>16s}" if fleet_axis
           else ""),
    ]
    for c in report["cells"]:
        m = c["metrics"]

        def pm(key: str, digits: int = 1) -> str:
            if key not in m:
                return "-"
            return (f"{m[key]['mean']:.{digits}f}"
                    f"±{m[key]['ci95']:.{digits}f}")

        fl = ""
        if fleet_axis:
            spec = c.get("fleet")
            fl = f"{spec['strategy'] if spec else 'per-vm':12s} "
        lines.append(
            f"{str(c['regime']):11s} {c['policy']:18s} "
            f"{c['migration']:15s} {fl}{pm('interruptions'):>20s} "
            f"{pm('max_interruption_time'):>18s} {pm('migrations'):>12s} "
            f"{pm('realized_spot_cost', 3):>17s}"
            + (f" {pm('time_below_target_s'):>18s} "
               f"{pm('mean_recovery_s'):>16s}" if fleet_axis else ""))
    return "\n".join(lines)
