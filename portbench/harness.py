"""One run of one benchmark cell: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by name, so a new cell or metric is new files and new entries in
``BENCHMARK.json``:

* ``configs/<config>.json``   the deployment: generator sizes, policy,
  simulator settings, and the ``driver`` that runs it;
* ``workloads/<traffic>.json`` the traffic mix's parameters;
* ``limits/<cell>.json``      the numbers the check compares, each with
  its limit;
* ``drivers/<driver>.py``     inputs from a seed, a replay's simulator
  built through the program, the plain reference's judgement;
* ``metrics/<metric>.py``     a reader: ``read(rec)`` returns the metric
  from the run record, or None when it finds nothing to read.

A run replays the cell's traffic for the window: each replay builds a fresh
simulator through the program and runs it to the traffic's horizon.  The
replays of a run are run in lockstep, one chunk of simulated time each in
turn, so that a window cut anywhere has done the same share of every
replay's work; when all have reached the horizon they are built afresh.  A
replay cut by the window's end counts by the simulated time it reached.
Replay seeds come from ``--seed`` as a seed sweep's do, or, where the
traffic file fixes them (``replay_seeds``), ``--seed`` orders that fixed set:
every run then does the same work.  Decisions (calls into the allocation
policy's host-selection entries) are timed by the benchmark's own wrapper;
placements are logged at the host pool, and the plain reference judges them
after the window.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
#: the policy's host-selection entries, timed as one decision each (a
#: migration's destination host is chosen through ``_pick_direct``)
DECISION_ENTRIES = ("find_host", "find_direct", "find_first_direct",
                    "find_hosts_batch", "_pick_direct")
#: top-level module names that may not be loaded once the window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


@dataclass
class Cell:
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.config['driver']}")


def load_cell(name: str, root: Path = ROOT,
              config_overrides: Optional[Dict] = None,
              traffic_overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files."""
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def applies(m: Dict) -> bool:
        return "workloads" not in m or name in m["workloads"]

    return Cell(
        name=name, entry=entry,
        config=_merge(read_json(root / cfg["file"]), config_overrides),
        traffic=_merge(read_json(root / "portbench" / "workloads"
                                 / f"{entry['traffic']}.json"),
                       traffic_overrides),
        limits=read_json(root / "portbench" / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def load_reader(metric: str, root: Path = ROOT) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def replay_seeds(seed: int, n: int) -> List[int]:
    """The seeds of a run's replays: a seed sweep from ``seed``."""
    return [int(seed) * n + k for k in range(n)]


def run_replay_seeds(traffic: Dict, seed: int) -> List[int]:
    """The replay seeds of a run with ``seed``: the traffic's fixed
    ``replay_seeds`` in an order drawn from ``seed``, or else a seed sweep
    of ``replays_prepared`` from ``seed``."""
    import numpy as np
    fixed = traffic.get("replay_seeds")
    if fixed is None:
        return replay_seeds(seed, int(traffic["replays_prepared"]))
    order = np.random.default_rng([int(seed), 2]).permutation(len(fixed))
    return [int(fixed[i]) for i in order]


def host_sample() -> Dict[str, float]:
    """The host's load and this process's clocks at one moment: the load
    average, this process's CPU seconds, its involuntary context switches,
    and the clock rate of the cores it may run on."""
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"load1": os.getloadavg()[0], "cpu_s": ru.ru_utime + ru.ru_stime,
           "nivcsw": float(ru.ru_nivcsw)}
    try:
        cpus = os.sched_getaffinity(0)
        with open("/proc/cpuinfo") as f:
            mhz, cpu = [], None
            for line in f:
                if line.startswith("processor"):
                    cpu = int(line.split(":")[1])
                elif line.startswith("cpu MHz") and cpu in cpus:
                    mhz.append(float(line.split(":")[1]))
        if mhz:
            out["mhz"] = sum(mhz) / len(mhz)
    except (OSError, ValueError):
        pass
    return out


def seconds_since_process_start() -> Optional[float]:
    """Seconds since this process started, from the kernel's clock."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except OSError:
        return None
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


@dataclass
class Record:
    """What one run measured; the metric readers read it."""

    setup_s: float = 0.0
    setup_split: Dict[str, float] = field(default_factory=dict)
    window_s: float = 0.0
    sim_s: float = 0.0
    decide_ns: List[int] = field(default_factory=list)
    build_s: List[float] = field(default_factory=list)
    replays: List[Dict] = field(default_factory=list)
    #: traced runs: self seconds of the program's tracer spans by category
    span_self: Dict[str, float] = field(default_factory=dict)
    #: traced runs: device activity (name, start_us, end_us), window length
    device_events: Optional[List[tuple]] = None
    profiled_s: float = 0.0
    #: traced runs: (n, d, b) of every call into the scoring kernel entry
    kernel_calls: List[tuple] = field(default_factory=list)
    #: traced runs: replay-build intervals on the profiler's clock (us)
    build_us: List[tuple] = field(default_factory=list)
    #: seconds the reference's check took after the window
    check_s: float = 0.0
    #: seconds of the harness's bookkeeping inside the window, off its clock
    paused_s: float = 0.0
    #: the host around the window: ``host_sample`` before and after
    host: Dict[str, Dict[str, float]] = field(default_factory=dict)


class _Timed:
    """Wraps one replay's policy entries and host pool: each decision is
    timed, each placement logged (vm id, host, simulated time).  With
    ``traced``, each decision is also a ``policy`` span of the replay's
    tracer, so that the spans around it count its time as their children's,
    not as their own."""

    def __init__(self, sim, decide_ns: List[int], traced: bool = False):
        self.placements: List[tuple] = []
        self.count = 0
        self._depth = 0
        self._sim = sim
        self._tracer = sim.obs if traced else None
        policy = sim.policy
        for entry in DECISION_ENTRIES:
            setattr(policy, entry, self._timed(getattr(policy, entry),
                                               decide_ns, entry))
        place = sim.pool.place
        log = self.placements

        def logged(vm, hid, now=0.0):
            log.append((vm.id, int(hid), now))
            place(vm, hid, now=now)

        sim.pool.place = logged

    def close(self) -> None:
        """Take the wrappers off.  Each holds a bound method of the object
        it is set on, a reference cycle that would leave the whole replay's
        simulator to the cyclic collector, at a moment of its choosing
        inside a later replay."""
        sim, self._sim = self._sim, None
        for entry in DECISION_ENTRIES:
            sim.policy.__dict__.pop(entry, None)
        sim.pool.__dict__.pop("place", None)

    def _timed(self, fn, out: List[int], entry: str):
        clock = time.perf_counter_ns
        tracer = self._tracer

        def timed(*args, **kwargs):
            if self._depth:
                return fn(*args, **kwargs)
            self._depth = 1
            if tracer is not None:
                tracer.begin("policy", entry)
            t0 = clock()
            try:
                return fn(*args, **kwargs)
            finally:
                out.append(clock() - t0)
                self.count += 1
                if tracer is not None:
                    tracer.end(self._sim.now)
                self._depth = 0
        return timed


class _KernelShapes:
    """Records the (n, d, b) of each call into the program's scoring-kernel
    entries (``kernels/ops.py``) while active."""

    NAMES = ("hlem_score", "hlem_score_batch")

    def __init__(self, calls: List[tuple]):
        from repro_torch.kernels import ops
        self.ops, self.calls, self.saved = ops, calls, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(fn, name == "hlem_score"))
        return self

    def _wrap(self, fn, single: bool):
        calls = self.calls

        def recorded(free, masks, *args):
            n, d = free.shape
            calls.append((n, d, 1 if single else masks.shape[0]))
            return fn(free, masks, *args)
        return recorded

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def _device_events(prof) -> List[tuple]:
    """(name, start_us, end_us) of every device activity in a profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == cuda:
            out.append((e.name, float(e.time_range.start),
                        float(e.time_range.end)))
    out.sort(key=lambda r: r[1])
    return out


def _window(cell: Cell, prepared: List[Dict], seconds: float, device: str,
            traced: bool, rec: Record, break_sim=None,
            origin: Optional[float] = None) -> None:
    """The prepared replays in lockstep for ``seconds`` of the program's
    wall time: each round advances every live replay by one chunk of
    simulated time; when all have reached the horizon, they are built
    afresh.  The harness's own bookkeeping (reading a finished or cut
    replay's outputs and counts) stops the clock."""
    drv = cell.driver
    horizon = drv.horizon(cell)
    chunk = float(cell.traffic["chunk_s"])
    clock = time.perf_counter
    t_start = clock()
    deadline = t_start + seconds
    paused = 0.0

    def close(r: Dict) -> None:
        """Read a finished or cut replay's outputs.  One that the window
        closed on before its first chunk has simulated nothing, not its
        time 0, and leaves no record: only its build counts."""
        nonlocal paused, deadline
        t_book = clock()
        sim, timed = r.pop("sim"), r.pop("timed")
        done = r["reached"] >= horizon
        rec.sim_s += r["reached"]
        if r.pop("ran"):
            r.update(decisions=timed.count, completed=done,
                     placements=timed.placements, observed=drv.observe(sim),
                     counts=drv.program_counts(sim) if done else None)
            rec.replays.append(r)
        if traced:
            for (cat, _name), (_n, _tot, self_s) in sim.obs.profile().items():
                rec.span_self[cat] = rec.span_self.get(cat, 0.0) + self_s
        timed.close()
        book = clock() - t_book
        paused += book
        deadline += book

    while clock() < deadline:
        live: List[Dict] = []
        for k, inputs in enumerate(prepared):
            tb = clock()
            sim = drv.build(inputs, cell, device, traced)
            te = clock()
            rec.build_s.append(te - tb)
            if origin is not None:
                rec.build_us.append(((tb - origin) * 1e6,
                                     (te - origin) * 1e6))
            timed = _Timed(sim, rec.decide_ns, traced)
            if break_sim is not None:
                break_sim(sim)
            live.append({"seed": inputs["seed"], "inputs": k, "sim": sim,
                         "timed": timed, "build_s": te - tb, "run_s": 0.0,
                         "reached": 0.0, "ran": False})
            del sim, timed
            if clock() >= deadline:
                break
        while live and clock() < deadline:
            for r in list(live):
                t = min(r["reached"] + chunk, horizon)
                tc = clock()
                r["sim"].run(until=t)
                r["reached"], r["ran"] = t, True
                r["run_s"] += clock() - tc
                if t >= horizon:
                    live.remove(r)
                    close(r)
                if clock() >= deadline:
                    break
        for r in live:
            close(r)
        del live
    rec.window_s = clock() - t_start - paused
    rec.paused_s = paused


def judge_window(cell: Cell, prepared: List[Dict], replays: List[Dict],
                 seed: int) -> Dict:
    """The plain reference's judgement of a window's replays.

    Every placement is checked; a sample of them (drawn from ``seed``, of
    the size the cell's limits file gives) is also scored; finished
    replays' lifecycle counts are compared.  Each number the limits file
    names is gathered over the replays (the widest for a ``*_max``, else
    the sum).  Returns {name: (value, limit)} under ``checks``, the number
    of decisions judged wrong, and how many were scored."""
    import numpy as np

    drv = cell.driver
    limits = {k: v["limit"] for k, v in cell.limits.items()
              if isinstance(v, dict)}
    sizes = [len(r["placements"]) for r in replays]
    total = sum(sizes)
    k = min(int(cell.limits["scored_sample"]), total)
    pick = np.sort(np.random.default_rng([int(seed), 1]).choice(
        total, size=k, replace=False)) if k else np.zeros(0, np.int64)
    values = {name: 0 for name in limits}
    failed = judged = 0
    start = 0
    for r, size in zip(replays, sizes):
        lo, hi = np.searchsorted(pick, [start, start + size])
        j = drv.judge(prepared[r["inputs"]], r, cell, pick[lo:hi] - start,
                      limits)
        start += size
        readings = dict(j["readings"])
        if r["completed"] and r.get("counts") is not None:
            readings["counts_off"] = sum(
                1 for key, v in j["counts"].items()
                if r["counts"].get(key) != v)
        for name in limits:
            v = readings.get(name, 0)
            values[name] = (max(values[name], v) if name.endswith("_max")
                            else values[name] + v)
        failed += j["failed"]
        judged += j["judged"]
    return {"checks": {name: (values[name], limits[name])
                       for name in limits},
            "failed": failed, "judged": judged}


def loaded_forbidden() -> List[str]:
    """Top-level names of the loaded modules that a run may not load (JAX
    and the JAX package), compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def _nvidia_smi() -> Dict:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, limit = [s.strip() for s in out[0].split(",", 1)]
    return {"smi_name": name, "power_limit": limit}


def _breakdown(rec: Record) -> Dict:
    """The device operations that took most time, and the idle time between
    device operations by what the host did there: building a replay, or
    the stretch between two device operations, named by them."""
    by_op: Dict[str, float] = {}
    for name, t0, t1 in rec.device_events:
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0) * 1e-6
    gaps: Dict[str, float] = {}
    ev = rec.device_events

    def short(s: str) -> str:
        for junk in ("void ", "(anonymous namespace)::"):
            s = s.replace(junk, "")
        return s.split("<")[0].split("(")[0].strip()[:48]

    for (a, _, a1), (b, b0, _) in zip(ev, ev[1:]):
        if b0 <= a1:
            continue
        if any(s < b0 and e > a1 for s, e in rec.build_us):
            label = "host: replay build (between replays)"
        else:
            label = f"host: after {short(a)} before {short(b)}"
        gaps[label] = gaps.get(label, 0.0) + (b0 - a1) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def busy_s(events: List[tuple]) -> float:
    """Seconds in which some device activity of ``events`` ran."""
    busy, end = 0.0, float("-inf")
    for _, t0, t1 in events:
        if t1 <= end:
            continue
        busy += t1 - max(t0, end)
        end = t1
    return busy * 1e-6


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = ROOT,
        config_overrides: Optional[Dict] = None,
        traffic_overrides: Optional[Dict] = None,
        break_sim=None, t_imports: float = 0.0) -> Dict:
    """One run of cell ``name``: returns the result line's object.

    ``break_sim``, when given, is applied to each replay's simulator before
    it runs: the harness's own tests plant faults in the timed path with it.
    """
    import torch

    rec = Record()
    t0 = time.perf_counter()
    cell = load_cell(name, root, config_overrides, traffic_overrides)
    drv = cell.driver
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    prepared = [drv.prepare(cell, s)
                for s in run_replay_seeds(cell.traffic, seed)]
    t2 = time.perf_counter()
    # warm-up: a prefix of one replay, at the cell's own fleet size; the
    # first one builds or loads the scoring kernel
    warm = drv.build(prepared[0], cell, device, False)
    warm.run(until=float(cell.traffic["warmup_sim_s"]))
    del warm
    # the inputs and everything loaded so far live to the end: keep them out
    # of the cyclic collector's passes inside the window
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    rec.setup_split = {"imports": t_imports, "cuda_init": t1 - t0,
                       "inputs": t2 - t1, "warmup_and_kernel_load": t3 - t2}

    prof = None
    origin = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        origin = time.perf_counter()
    since = seconds_since_process_start()
    rec.setup_s = since if since is not None else t_imports + (t3 - t0)
    shapes = _KernelShapes(rec.kernel_calls) if trace else None
    if shapes is not None:
        shapes.__enter__()
    rec.host["before"] = host_sample()
    try:
        _window(cell, prepared, seconds, device, trace, rec, break_sim,
                origin)
        if cuda:
            torch.cuda.synchronize()
        rec.host["after"] = host_sample()
    finally:
        gc.unfreeze()
        if shapes is not None:
            shapes.__exit__()
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    if prof is not None:
        rec.device_events = _device_events(prof)
        rec.profiled_s = rec.window_s + rec.paused_s
        del prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    verdict = judge_window(cell, prepared, rec.replays, seed)
    rec.check_s = time.perf_counter() - t_check
    checks = verdict["checks"]
    correct = all(v <= lim for v, lim in checks.values())

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if cuda:
        dev.update(_nvidia_smi())
    out = {"correct": bool(correct), "attempted": len(rec.decide_ns),
           "failed": int(verdict["failed"]), "metrics": metrics,
           "device": dev}
    if trace and rec.device_events is not None:
        dev["busy_s"] = busy_s(rec.device_events)
        dev["window_s"] = rec.profiled_s
        out["breakdown"] = _breakdown(rec)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    out["_record"] = rec
    out["_judged"] = verdict["judged"]
    return out
