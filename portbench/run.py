"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, with its limit (also the last lines of standard error).  Exits
non-zero, printing no result, without a CUDA device, or when a JAX module
or the JAX package is loaded when the window closes.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the run stays inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process, one compute thread: the simulator's host work is serial, and
# idle pool threads only add noise beside it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# ... on one core, before any thread starts: the scheduler then never moves
# the simulator's thread, and its caches stay warm through the window
try:
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
except (AttributeError, OSError):
    pass
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from portbench import harness
    import repro_torch  # noqa: F401  (the program; fails where it is absent)

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    t_imports = time.perf_counter() - T_START
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_imports=t_imports)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"modules loaded by the window's close: {forbidden}",
              file=sys.stderr)
        return 3
    rec = out.pop("_record")
    judged = out.pop("_judged")
    print(f"setup split (s): {json.dumps(rec.setup_split)}; replays "
          f"{len(rec.replays)} ({sum(r['completed'] for r in rec.replays)} "
          f"finished), decisions {len(rec.decide_ns)}, scored {judged}, "
          f"window {rec.window_s:.3f} s, check {rec.check_s:.3f} s",
          file=sys.stderr)
    h0, h1 = rec.host.get("before", {}), rec.host.get("after", {})
    if h0 and h1:
        print(f"host: cores {sorted(os.sched_getaffinity(0))}, load "
              f"{h0['load1']:.2f} -> {h1['load1']:.2f}, cpu "
              f"{h1['cpu_s'] - h0['cpu_s']:.3f} s in the window, "
              f"{h1['nivcsw'] - h0['nivcsw']:.0f} involuntary switches, "
              f"MHz {h0.get('mhz', 0):.0f} -> {h1.get('mhz', 0):.0f}",
              file=sys.stderr)
    for r in rec.replays:
        per = r["run_s"] / r["reached"] * 1e3 if r["reached"] else 0.0
        print(f"replay seed {r['seed']}: build {r['build_s']:.3f} s, run "
              f"{r['run_s']:.3f} s to t={r['reached']:g} "
              f"({r['decisions']} decisions; {per:.3f} ms a simulated s)",
              file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
