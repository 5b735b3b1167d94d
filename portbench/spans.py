"""The program's own spans and counters inside the placement decision, read
on the device trace's clock.

The program's tracer (``repro_torch.obs.tracer``) opens a ``policy/<entry>``
span for each decision (its outermost host-selection entry), with children
``policy/filter`` (masks, admission, RsDiff), ``policy/feasibility`` (the
queue x fleet matrix), ``policy/stage`` (staging and the H2D copy),
``policy/launch`` (the kernel entry to its launch) and ``policy/select``
(argmax, D2H and the wait for the kernel), and a ``build/wire_trace`` or
``build/populate`` span around a replay's build; it counts ``hlem/calls``,
``hlem/staged_bytes``, ``hlem/rescored``, ``flush/passes``,
``flush/rows_scanned`` and ``flush/rows_tested``.  This module reads them,
in pure functions that a traced run's breakdown and per-layer readers can
call:

* :func:`readings`: the per-decision numbers, from the tracers' profiles
  and counters summed over a window's replays;
* :func:`label_idle_gaps`: each idle stretch of the card named by the
  program span that is innermost over most of it (``host: policy/launch``),
  a replay's build, or else the device operations around it as the
  harness's breakdown names them today;
* :func:`fit_offset`, :func:`device_on_host`: the clock mapping (below);
* :func:`causal_check` and :func:`holdout_check`: the mapping held to
  causality.

The mapping.  The tracer stamps spans on its clock, anchored on real time
(``Tracer.to_unix_ns``), which the CUDA profiler's trace counts from.  The
trace's own device times wander against its host records of the runtime
calls, by up to milliseconds over seconds (a kernel seen starting before
the call that launched it), so the real-time anchor alone fails the causal
check.  The runtime calls agree with the spans up to a constant offset:
:func:`fit_offset` finds the one that puts each scoring kernel's launch
call inside its ``policy/launch`` span, and :func:`device_on_host` moves
each scoring call's device records onto their runtime calls.  By
construction a kernel then starts inside its launch span; what can fail is
a D2H copy ending after its ``policy/select`` span, and a held-out launch
call falling outside its span.

:func:`measure` is a thin command line over ``harness.run``:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

prints one JSON object (``--device cpu`` runs it without the card, and
without its trace).  The harness's ``--trace 1`` runs do not report these
numbers: its ``Record`` holds self time by category only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import harness  # noqa: E402

#: the program's decision spans: one per decision, its outermost entry
ENTRY_SPANS = tuple("policy/" + e for e in harness.DECISION_ENTRIES)
#: their children, each a boundary where work happens
CHILD_SPANS = ("policy/filter", "policy/feasibility", "policy/stage",
               "policy/launch", "policy/select")
KERNEL = "hlem_score_kernel"
BUILD_LABEL = "host: replay build (between replays)"


def add_profile(total: Dict, profile: Dict) -> None:
    """Fold one tracer's ``(cat, name) -> [count, total_s, self_s]`` into
    ``total``."""
    for key, (n, tot, self_s) in profile.items():
        t = total.setdefault(key, [0, 0.0, 0.0])
        t[0] += n
        t[1] += tot
        t[2] += self_s


def add_counters(total: Dict, values: Dict) -> None:
    for k, v in values.items():
        total[k] = total.get(k, 0) + v


def readings(profile: Dict, counters: Dict, replays: int = 0
             ) -> Dict[str, float]:
    """The decision's split from a window's summed profile and counters:
    ``decisions`` (the program's decision spans), and per decision or call
    the numbers a reader would report; with the number of ``replays``
    built, the ``build`` spans' time a replay.  A number whose spans or
    counters are absent is left out."""
    def count(name):
        return profile.get(("policy", name), (0, 0.0, 0.0))[0]

    def self_s(*names):
        return sum(profile.get(("policy", n), (0, 0.0, 0.0))[2]
                   for n in names)

    out: Dict[str, float] = {}
    decisions = sum(count(n) for n in ENTRY_SPANS)
    out["decisions"] = decisions
    calls = counters.get("hlem/calls", 0)
    if decisions:
        out["filter_us_per_decide"] = 1e6 * self_s(
            "policy/filter", "policy/feasibility") / decisions
        out["stage_us_per_decide"] = 1e6 * self_s("policy/stage") / decisions
        out["entry_self_us_per_decide"] = 1e6 * self_s(*ENTRY_SPANS) / decisions
        out["split_us_per_decide"] = 1e6 * self_s(
            *ENTRY_SPANS, *CHILD_SPANS) / decisions
        out["scores_per_decide"] = calls / decisions
        out["rescored_per_decide"] = counters.get("hlem/rescored", 0) / decisions
    for name, key in (("policy/launch", "launch_us_per_call"),
                      ("policy/select", "select_us_per_call")):
        if count(name):
            out[key] = 1e6 * self_s(name) / count(name)
    if calls:
        out["staged_kb_per_call"] = (counters.get("hlem/staged_bytes", 0)
                                     / calls / 1024)
    passes = counters.get("flush/passes", 0)
    if passes:
        out["flush_rows_per_pass"] = (counters.get("flush/rows_scanned", 0)
                                      / passes)
        out["flush_rows_tested_per_pass"] = (
            counters.get("flush/rows_tested", 0) / passes)
    build_s = sum(v[2] for (cat, _), v in profile.items() if cat == "build")
    if replays and build_s:
        out["build_ms_per_replay"] = 1e3 * build_s / replays
    return out


def span_label(cat: str, name: str) -> str:
    return name if name.startswith(cat + "/") else f"{cat}/{name}"


def span_intervals(tracer) -> List[Tuple[str, int, int]]:
    """(label, start_ns, end_ns) of every span record of ``tracer``, on the
    real-time clock."""
    to_ns = tracer.to_unix_ns
    return [(span_label(cat, name), to_ns(t0), to_ns(t0 + dur))
            for cat, name, t0, dur, _sim, _self, _args in tracer.spans]


def innermost(spans: Iterable[Tuple[str, int, int]]
              ) -> List[Tuple[int, int, str]]:
    """The time line of nested spans as (start, end, label) segments, each
    labelled by the span innermost there, in time order."""
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []     # (end, label), outermost first
    cur = None
    for label, s0, s1 in sorted(spans, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][0] <= s0:
            end, top = stack.pop()
            segs.append((cur, end, top))
            cur = end
        if stack:
            segs.append((cur, s0, stack[-1][1]))
        stack.append((s1, label))
        cur = s0
    while stack:
        end, top = stack.pop()
        segs.append((cur, end, top))
        cur = end
    return [s for s in segs if s[1] > s[0]]


def _short(s: str) -> str:
    for junk in ("void ", "(anonymous namespace)::"):
        s = s.replace(junk, "")
    return s.split("<")[0].split("(")[0].strip()[:48]


def label_idle_gaps(events: Sequence[Tuple[str, int, int]],
                    spans: Iterable[Tuple[str, int, int]],
                    builds: Sequence[Tuple[int, int]] = ()
                    ) -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
    """Seconds of idle time between consecutive device operations
    (``events``: (name, start_ns, end_ns) in start order, as the harness
    pairs them), by label: a replay's build where one overlaps the gap, else
    ``host: <span>`` for the span innermost over most of the gap, else the
    harness's ``host: after <a> before <b>``.  Also returns, for each of the
    harness's labels, the seconds now under each label."""
    segs = innermost(spans)
    gaps: Dict[str, float] = {}
    moved: Dict[str, Dict[str, float]] = {}
    k = 0
    for (a, _, a1), (b, b0, _) in zip(events, events[1:]):
        if b0 <= a1:
            continue
        old = f"host: after {_short(a)} before {_short(b)}"
        if any(s < b0 and e > a1 for s, e in builds):
            label = BUILD_LABEL
        else:
            while k < len(segs) and segs[k][1] <= a1:
                k += 1
            cover: Dict[str, int] = {}
            j = k
            while j < len(segs) and segs[j][0] < b0:
                s, e, lab = segs[j]
                cover[lab] = cover.get(lab, 0) + min(e, b0) - max(s, a1)
                j += 1
            label = ("host: " + max(cover, key=cover.get) if cover
                     else old)
        sec = (b0 - a1) * 1e-9
        gaps[label] = gaps.get(label, 0.0) + sec
        m = moved.setdefault(old, {})
        m[label] = m.get(label, 0.0) + sec
    return gaps, moved


def causal_check(events: Sequence[Tuple[str, int, int]],
                 spans: Iterable[Tuple[str, int, int]],
                 skip: frozenset = frozenset()) -> Dict:
    """Each scoring kernel must start after the start of the
    ``policy/launch`` span that launched it, each pick's D2H copy end
    before the end of its ``policy/select`` span; pairs are taken in order
    (one of each a scoring call), and pairs whose device event is in
    ``skip`` are left out.  Returns the pairs' counts, the smallest slack on
    each side (us; negative where causality fails) and the number of
    failures."""
    launch, select = [], []
    for label, s0, s1 in spans:
        if label == "policy/launch":
            launch.append(s0)
        elif label == "policy/select":
            select.append(s1)
    launch.sort()
    select.sort()
    kernels = sorted((r[1], r in skip) for r in events if KERNEL in r[0])
    d2h = sorted((r[2], r in skip) for r in events if "DtoH" in r[0])
    out = {"launch_spans": len(launch), "kernels": len(kernels),
           "select_spans": len(select), "d2h_copies": len(d2h)}
    if len(launch) != len(kernels) or len(select) != len(d2h) or not launch:
        out["paired"] = False
        return out
    kslack = [k - s for (k, bad), s in zip(kernels, launch) if not bad]
    dslack = [s - d for (d, bad), s in zip(d2h, select) if not bad]
    out.update(paired=True, left_out=len(kernels) - len(kslack)
               + len(d2h) - len(dslack),
               kernel_after_launch_min_us=min(kslack, default=0) * 1e-3,
               d2h_before_select_end_min_us=min(dslack, default=0) * 1e-3,
               failures=sum(x < 0 for x in kslack) + sum(x < 0 for x in dslack))
    return out


def _trace_records(prof) -> Tuple[List[tuple], List[tuple]]:
    """The profile's device activity and its CUDA runtime calls, as
    (name, start_ns, end_ns, correlation id) in start order, on the trace's
    clock (ns since the Unix epoch)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, api = [], []
    for e in prof.profiler.kineto_results.events():
        r = (e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        if e.device_type() == cuda:
            dev.append(r)
        elif r[0].startswith("cuda"):
            api.append(r)
    dev.sort(key=lambda r: r[1])
    api.sort(key=lambda r: r[1])
    return dev, api


def fit_offset(launch: Sequence[Tuple[int, int]],
               calls: Sequence[Tuple[int, int]]) -> Optional[Dict]:
    """The constant offset ``a`` from the program's clock (the tracer's
    real-time anchor) to the trace's that puts each runtime call that
    launched a scoring kernel (``calls``, on the trace's clock) inside the
    ``policy/launch`` span it was made from (``launch``, on the program's),
    with the widest margin ``m`` on both sides (ns; negative where no
    offset fits)."""
    if not launch or len(launch) != len(calls):
        return None
    early = min(r0 - l0 for (l0, _), (r0, _) in zip(launch, calls))
    late = max(r1 - l1 for (_, l1), (_, r1) in zip(launch, calls))
    return {"a_ns": 0.5 * (early + late), "margin_ns": 0.5 * (early - late)}


def holdout_check(launch: Sequence[Tuple[int, int]],
                  calls: Sequence[Tuple[int, int]]) -> Optional[Dict]:
    """The offset fitted on every other scoring call and held to the rest:
    the smallest slack (us) of a held-out runtime call inside its moved
    ``policy/launch`` span, and the number that fall outside it.  In
    sample, a fit with a margin puts every call inside its span by
    construction; out of sample, a call can fall outside."""
    fit = fit_offset(launch[::2], calls[::2])
    if fit is None or len(launch) < 2 or len(launch) != len(calls):
        return None
    a = fit["a_ns"]
    slack = [min(r0 - (l0 + a), (l1 + a) - r1)
             for (l0, l1), (r0, r1) in zip(launch[1::2], calls[1::2])]
    return {"a_ns": a, "checked": len(slack),
            "min_slack_us": min(slack) * 1e-3,
            "failures": sum(x < 0 for x in slack)}


def shift(spans: Iterable[Tuple[str, int, int]], a_ns: float
          ) -> List[Tuple[str, int, int]]:
    """``spans`` moved onto the trace's clock by the offset ``a_ns``."""
    a = round(a_ns)
    return [(lab, s0 + a, s1 + a) for lab, s0, s1 in spans]


def scoring_calls(dev: Sequence[tuple], api: Sequence[tuple]
                  ) -> List[Tuple[int, int]]:
    """The runtime calls that launched a scoring kernel (matched by
    correlation id), in the host's order: the order of the launches."""
    by_id = {r[3]: (r[1], r[2]) for r in api}
    return sorted(by_id[r[3]] for r in dev if KERNEL in r[0] and r[3] in by_id)


def device_on_host(dev: Sequence[tuple], api: Sequence[tuple]
                   ) -> Tuple[List[Tuple[str, int, int]], set, Dict]:
    """The device records moved onto the trace's host clock, one scoring
    call at a time.  The trace's device times wander against its own host
    records (a kernel seen starting before the runtime call that launched
    it); each group of device work enqueued from a host-to-device copy's
    call to the next (a scoring call: copy, kernel, argmax, D2H of the
    pick) is shifted by the midpoint of what its runtime records allow: no
    device op starts before the call that enqueued it, none ends after the
    first stream synchronize that follows that call.  Returns the moved
    events (name, start_ns, end_ns) in start order, the set of moved events
    of groups whose records allow no shift (the device clock jumped inside
    the group), and the shifts' summary (us)."""
    import bisect
    import numpy as np
    calls = {r[3]: r for r in api}
    syncs = [r for r in api if r[0] in ("cudaStreamSynchronize",
                                        "cudaDeviceSynchronize")]
    sync_starts = [r[1] for r in syncs]
    # host order: the order of the calls that enqueued them
    ordered = sorted(dev, key=lambda r: calls[r[3]][1] if r[3] in calls
                     else r[1])
    groups: List[List[tuple]] = []
    for r in ordered:
        if not groups or "HtoD" in r[0]:
            groups.append([])
        groups[-1].append(r)
    out, faulty, shifts, widths, jumps = [], set(), [], [], 0
    for g in groups:
        hi, lo = float("inf"), float("-inf")
        for name, d0, d1, corr in g:
            call = calls.get(corr)
            if call is None:
                continue
            hi = min(hi, d0 - call[1])
            k = bisect.bisect_right(sync_starts, call[1])
            if k < len(syncs):
                lo = max(lo, d1 - syncs[k][2])
        e = 0.0 if hi == float("inf") or lo == float("-inf") \
            else 0.5 * (hi + lo)
        moved = [(name, d0 - round(e), d1 - round(e))
                 for name, d0, d1, _ in g]
        if hi < lo:
            faulty.update(moved)
            jumps += 1
        elif e:
            widths.append(hi - lo)
        shifts.append(e)
        out.extend(moved)
    out.sort(key=lambda r: r[1])
    stats = {"groups": len(groups), "faulty_groups": jumps}
    if shifts:
        sh = np.array(shifts) * 1e-3
        stats.update(shift_min_us=float(sh.min()),
                     shift_max_us=float(sh.max()),
                     shift_p50_us=float(np.median(sh)))
    if widths:
        stats["width_p50_us"] = float(np.median(widths)) * 1e-3
        stats["width_max_us"] = float(max(widths)) * 1e-3
    return out, faulty, stats


@contextlib.contextmanager
def _keeping_profiler(kept: List):
    """While active, every ``torch.profiler.profile`` made is appended to
    ``kept``: the harness drops its own once it has read the device
    activity, and the runtime records are read from it afterwards."""
    import torch.profiler as tp
    made = tp.profile

    class Kept(made):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

    tp.profile = Kept
    try:
        yield
    finally:
        tp.profile = made


def measure(name: str, seed: int, seconds: float, device: str = "cuda",
            config_overrides: Optional[Dict] = None,
            traffic_overrides: Optional[Dict] = None) -> Dict:
    """One ``--trace 1`` run of cell ``name`` (``harness.run``), with each
    replay's tracer keeping span records: turned on through ``break_sim``,
    the hook the harness's own tests plant faults with, which sees each
    replay's simulator before it runs.  Returns the run's metrics and
    ``correct``, the readings, the split of a decision beside the harness's
    mean, and on the card the clock mapping, the causal check and the idle
    gaps by label."""
    tracers: List = []

    def keep_records(sim):
        sim.obs.keep_records = True
        tracers.append(sim.obs)

    kept: List = []
    with _keeping_profiler(kept):
        res = harness.run(name, seed, seconds, True, device, harness.ROOT,
                          config_overrides, traffic_overrides,
                          break_sim=keep_records)
    rec = res["_record"]
    profile: Dict = {}
    counters: Dict = {}
    spans: List[Tuple[str, int, int]] = []
    for tr in tracers:
        add_profile(profile, tr.profile())
        add_counters(counters, tr.counters.values)
        spans.extend(span_intervals(tr))
    out = {"cell": name, "seed": seed, "correct": res["correct"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "device": res["device"], "window_s": rec.window_s,
           "harness_decisions": len(rec.decide_ns),
           "harness_replay_build_ms": (1e3 * sum(rec.build_s)
                                       / max(len(rec.build_s), 1)),
           "readings": readings(profile, counters, len(tracers)),
           "counters": {k: v for k, v in sorted(counters.items())
                        if k.startswith(("hlem/", "flush/", "alloc/"))}}
    if rec.decide_ns:
        out["harness_decide_mean_us"] = sum(rec.decide_ns) / len(
            rec.decide_ns) * 1e-3
        split = out["readings"].get("split_us_per_decide")
        if split is not None:
            out["split_over_harness_mean"] = split / out[
                "harness_decide_mean_us"]
    if not kept:
        return out
    dev, api = _trace_records(kept[0])
    del kept
    events = [r[:3] for r in dev]
    # each replay's build from its tracer's epoch (taken as the driver makes
    # the tracer) for the harness's timed length of it
    builds = [(tr.epoch_unix_ns, tr.epoch_unix_ns + round(b * 1e9))
              for tr, b in zip(tracers, rec.build_s)]
    # first the real-time anchor alone; then the program's spans moved
    # onto the trace's host records, and the device records onto them
    out["causal_realtime"] = causal_check(events, spans)
    launch = sorted((s0, s1) for lab, s0, s1 in spans
                    if lab == "policy/launch")
    calls = scoring_calls(dev, api)
    fit = fit_offset(launch, calls)
    out["clock_fit"] = fit
    out["holdout"] = holdout_check(launch, calls)
    skip: frozenset = frozenset()
    if fit is not None:
        spans = shift(spans, fit["a_ns"])
        builds = [(b0, b1) for _, b0, b1 in
                  shift((("build", b0, b1) for b0, b1 in builds),
                        fit["a_ns"])]
        events, faulty, out["device_shift"] = device_on_host(dev, api)
        skip = frozenset(faulty)
    out["anchor"] = "runtime" if fit is not None else "realtime"
    gaps, moved = label_idle_gaps(events, spans, builds)
    out["causal"] = causal_check(events, spans, skip)
    out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()),
                              key=lambda kv: -kv[1])[:12]
    out["relabelled"] = {
        old: {"total_s": sum(new.values()),
              "named_s": sum(v for k, v in new.items()
                             if not k.startswith("host: after ")),
              "top": sorted(([k, v] for k, v in new.items()),
                            key=lambda kv: -kv[1])[:5]}
        for old, new in sorted(moved.items(),
                               key=lambda kv: -sum(kv[1].values()))[:5]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # one compute thread on one core, as the benchmark's own runs
    import torch
    torch.set_num_threads(1)
    try:
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    except (AttributeError, OSError):
        pass
    print(json.dumps(measure(args.workload, args.seed, args.seconds,
                             args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
