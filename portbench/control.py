"""The correctness check's control: the plain reference put in the program's
place at the precision below the configuration's, judged as a run is.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--replays R]

For each seed it makes the replays a run with that seed would make, lets
the reference decide every placement at float32 over R whole replays
(about as many decisions as one run's window), and judges them with the
cell's own check and limits.  A sound check reads the control as not
correct.  It runs on the CPU alone; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def control_run(name: str, seed: int, replays: int, dtype: str = "float32",
                config_overrides=None, traffic_overrides=None) -> dict:
    """One control reading: {checks, correct, decisions, seconds}."""
    import numpy as np
    from portbench import harness

    cell = harness.load_cell(name, config_overrides=config_overrides,
                             traffic_overrides=traffic_overrides)
    drv = cell.driver
    prepared = [drv.prepare(cell, s)
                for s in harness.run_replay_seeds(cell.traffic, seed)]
    n_prep = len(prepared)
    horizon = drv.horizon(cell)
    t0 = time.perf_counter()
    runs = [{"inputs": k % n_prep, "reached": horizon, "completed": True,
             "counts": None,
             **drv.control(prepared[k % n_prep], horizon, cell,
                           np.dtype(dtype).type)}
            for k in range(replays)]
    verdict = harness.judge_window(cell, prepared, runs, seed)
    checks = verdict["checks"]
    return {"seed": seed, "dtype": dtype,
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()},
            "decisions": sum(len(r["placements"]) for r in runs),
            "scored": verdict["judged"], "failed": verdict["failed"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--replays", type=int, default=3)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_run(args.workload, seed, args.replays)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
