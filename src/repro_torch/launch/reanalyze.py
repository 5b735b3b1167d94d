"""Recompute the dry-run's totals and roofline terms from the saved per-op
counts and update the result JSONs in place, without tracing again.

A port of the reference package's ``launch/reanalyze.py``, which re-parses
the saved HLO; here the saved artefact is ``dryrun``'s per-op counts
(``ops/<cell>.json.gz``).  Used when the roofline constants or the way the
counts are totalled change.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .hlo_analyzer import HloAnalysis
from .hlo_stats import roofline_terms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    for path in sorted(glob.glob(os.path.join(args.results, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        stem = os.path.splitext(os.path.basename(path))[0]
        ops_path = os.path.join(args.results, "ops", stem + ".json.gz")
        if not os.path.exists(ops_path):
            print(f"[no-ops] {stem}")
            continue
        with gzip.open(ops_path, "rt") as f:
            ana = HloAnalysis.from_ops(json.load(f))
        chips = rec["chips"]
        flops_g = ana.flops * chips
        rec["hlo_analysis"] = ana.asdict()
        rec["hlo_flops"] = flops_g
        mf = rec.get("model_flops", 0.0)
        rec["useful_flops_ratio"] = (mf / flops_g) if flops_g else None
        rec["roofline"] = roofline_terms(
            flops_g, ana.hbm_bytes * chips, ana.collective_bytes * chips,
            chips)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        r = rec["roofline"]
        print(f"[ok] {stem}: dom={r['dominant']} "
              f"cmp={r['compute_s']*1e3:.1f}ms mem={r['memory_s']*1e3:.1f}ms "
              f"col={r['collective_s']*1e3:.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
