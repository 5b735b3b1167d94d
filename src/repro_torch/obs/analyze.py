"""Vectorized post-hoc queries over an event log.

The paper's deliverable includes "analytical insights into … market risk";
these are the queries that produce them, all running on the dense columns
of :meth:`repro_torch.obs.eventlog.EventLog.to_arrays` (numpy ``searchsorted`` /
``cumsum`` / ``unique`` — no per-event Python loops):

* :func:`interruption_intensity` / :func:`storm_intervals` — rolling-window
  interruption rate and the intervals where it exceeds a threshold (the
  "interruption storm" detector).
* :func:`pool_risk_series` — per-pool market-risk time series at tick
  resolution: clearing price, wave victim counts, live occupancy, and the
  bid danger margin (mean admitted bid minus price — how close the
  resident cohort sits to the interruption boundary).
* :func:`vm_lifecycle` — one VM's full event timeline, reconstructed.
* :func:`cohort_summary` — per-VM aggregates rolled up across the cohort.

Every function accepts an :class:`~repro_torch.obs.eventlog.EventLog` or a saved
log path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .eventlog import EventLog, load_event_log

LogLike = Union[EventLog, str]

#: event kinds that mean "a VM started occupying a host in this pool" /
#: "… stopped"; migrate-complete counts only when it landed (aux "ok")
_ARRIVALS = ("start", "resume")
_DEPARTURES = ("interrupt", "migrate-start")


def _log(src: LogLike) -> EventLog:
    return load_event_log(src) if isinstance(src, str) else src


def _kind_mask(arr: Dict[str, np.ndarray], log: EventLog,
               *kinds: str) -> np.ndarray:
    m = np.zeros(arr["kind"].size, dtype=bool)
    for k in kinds:
        m |= arr["kind"] == log.kind_id(k)
    return m


# ---------------------------------------------------------------------------
# interruption storms
# ---------------------------------------------------------------------------
def interruption_intensity(src: LogLike, window: float = 600.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Rolling interruption rate: for each interruption event at time t,
    the count of interruptions in ``(t - window, t]`` divided by the
    window (events/s).  Returns ``(times, intensity)`` — one point per
    interruption, which is exactly where the rate function changes."""
    log = _log(src)
    arr = log.to_arrays()
    t = arr["t"][_kind_mask(arr, log, "interrupt")]
    if t.size == 0:
        return np.zeros(0), np.zeros(0)
    # events are time-ordered; count via two searchsorted cursors
    lo = np.searchsorted(t, t - window, side="left")
    hi = np.arange(1, t.size + 1)
    return t, (hi - lo) / window


def storm_intervals(src: LogLike, window: float = 600.0,
                    threshold: float = 0.05,
                    min_gap: Optional[float] = None) -> List[dict]:
    """Intervals where the rolling interruption intensity is at or above
    ``threshold`` (events/s).  Consecutive above-threshold points closer
    than ``min_gap`` (default: ``window``) merge into one storm.  Each
    storm dict carries ``t0``/``t1``, its event count, and the peak
    intensity — the detector that turns a log into "storms hit at t=3600
    and t=6000"."""
    t, inten = interruption_intensity(src, window=window)
    hot = inten >= threshold
    if not hot.any():
        return []
    gap = window if min_gap is None else min_gap
    ht, hi_ = t[hot], inten[hot]
    # split where consecutive hot points are further apart than the gap
    breaks = np.flatnonzero(np.diff(ht) > gap) + 1
    storms = []
    for seg_t, seg_i in zip(np.split(ht, breaks), np.split(hi_, breaks)):
        storms.append({
            "t0": float(seg_t[0]), "t1": float(seg_t[-1]),
            "events": int(seg_t.size),
            "peak_intensity": float(seg_i.max()),
        })
    return storms


# ---------------------------------------------------------------------------
# per-pool market risk
# ---------------------------------------------------------------------------
def pool_risk_series(src: LogLike, pool: int) -> Dict[str, np.ndarray]:
    """Per-tick market-risk series for one pool.

    Returns ``t`` (the pool's price-tick times) and, aligned to it:
    ``price`` (clearing price), ``victims`` (wave victims in the tick
    interval ending at each t), ``occupancy`` (VMs resident in the pool —
    arrivals minus departures, cumulative), ``mean_bid`` (running mean of
    the bids admitted into the pool so far — an approximation of the
    resident cohort's bid level), and ``danger_margin`` (``mean_bid -
    price``: how much headroom the cohort has before the next wave; the
    margin going negative is the wave firing)."""
    log = _log(src)
    arr = log.to_arrays()
    in_pool = arr["pool"] == pool
    tick = _kind_mask(arr, log, "price-tick") & in_pool
    t = arr["t"][tick]
    price = arr["a"][tick]
    out: Dict[str, np.ndarray] = {"t": t, "price": price}
    # wave victims, bucketed into the tick interval they landed in
    wv = _kind_mask(arr, log, "wave") & in_pool
    victims = np.zeros(t.size)
    if t.size and wv.any():
        idx = np.clip(np.searchsorted(t, arr["t"][wv], side="left"),
                      0, t.size - 1)
        np.add.at(victims, idx, arr["b"][wv])
    out["victims"] = victims
    # occupancy: +1 at arrivals into the pool, -1 at departures; sampled
    # at tick boundaries (events at exactly t count — ticks run first)
    arrive = (_kind_mask(arr, log, *_ARRIVALS) & in_pool)
    mc = _kind_mask(arr, log, "migrate-complete") & in_pool
    if mc.any():
        aux_ok = log.aux_id("ok")
        if aux_ok >= 0:
            arrive |= mc & (arr["aux"] == aux_ok)
    depart = _kind_mask(arr, log, *_DEPARTURES) & in_pool
    depart |= (_kind_mask(arr, log, "finish") & in_pool)
    delta_t = np.concatenate([arr["t"][arrive], arr["t"][depart]])
    delta_v = np.concatenate([np.ones(int(arrive.sum())),
                              -np.ones(int(depart.sum()))])
    order = np.argsort(delta_t, kind="stable")
    occ_t, occ_v = delta_t[order], np.cumsum(delta_v[order])
    if t.size and occ_t.size:
        pos = np.searchsorted(occ_t, t, side="right") - 1
        out["occupancy"] = np.where(pos >= 0, occ_v[np.maximum(pos, 0)], 0.0)
    else:
        out["occupancy"] = np.zeros(t.size)
    # running mean of admitted bids (start/resume events carry the bid in a)
    bid_ev = _kind_mask(arr, log, *_ARRIVALS) & in_pool
    bt, bv = arr["t"][bid_ev], arr["a"][bid_ev]
    if t.size and bt.size:
        n = np.searchsorted(bt, t, side="right")
        csum = np.concatenate([[0.0], np.cumsum(bv)])
        mean_bid = np.where(n > 0, csum[n] / np.maximum(n, 1), np.nan)
    else:
        mean_bid = np.full(t.size, np.nan)
    out["mean_bid"] = mean_bid
    out["danger_margin"] = mean_bid - price
    return out


def victim_rate(src: LogLike, pool: Optional[int] = None) -> float:
    """Wave victims per tick (one pool, or the whole market)."""
    log = _log(src)
    arr = log.to_arrays()
    sel = np.ones(arr["kind"].size, dtype=bool) if pool is None \
        else arr["pool"] == pool
    ticks = int((_kind_mask(arr, log, "price-tick") & sel).sum())
    victims = float(arr["b"][_kind_mask(arr, log, "wave") & sel].sum())
    return victims / max(ticks, 1)


# ---------------------------------------------------------------------------
# serving scenario
# ---------------------------------------------------------------------------
def serve_series(src: LogLike,
                 window: float = 1800.0) -> Optional[Dict[str, np.ndarray]]:
    """Serving-scenario chart series, or ``None`` when the log carries no
    serve events (so non-serve consumers can branch cheaply).

    Returns serve-tick-aligned arrays — ``t`` / ``rate`` (the demand-curve
    arrival rate each tick integrated) / ``depth`` (global queue depth) /
    ``live`` (VMs holding an active request scheduler) — plus
    ``p95`` (trailing-``window`` p95 completion latency sampled at
    the same ticks; NaN before the first completion) and
    ``scale_t``/``scale_units`` (the autoscaler's target steps; empty
    when no autoscaler acted)."""
    log = _log(src)
    if log.kind_id("serve-sample") < 0 and log.kind_id("request-arrive") < 0:
        return None
    arr = log.to_arrays()
    out: Dict[str, np.ndarray] = {}
    sample = _kind_mask(arr, log, "serve-sample")
    arrive = _kind_mask(arr, log, "request-arrive")
    out["t"] = arr["t"][sample]
    out["depth"] = arr["a"][sample]
    out["live"] = arr["b"][sample]
    out["rate_t"] = arr["t"][arrive]
    out["rate"] = arr["b"][arrive]
    # trailing-window p95 latency, sampled at the serve ticks (one
    # percentile per tick over the completions inside (t-window, t])
    done = _kind_mask(arr, log, "request-done")
    dt, lat = arr["t"][done], arr["a"][done]
    t = out["t"]
    p95 = np.full(t.size, np.nan)
    if dt.size and t.size:
        lo = np.searchsorted(dt, t - window, side="left")
        hi = np.searchsorted(dt, t, side="right")
        for i, (l, h) in enumerate(zip(lo, hi)):
            if h > l:
                p95[i] = float(np.percentile(lat[l:h], 95.0))
    out["p95"] = p95
    scale = _kind_mask(arr, log, "autoscale")
    out["scale_t"] = arr["t"][scale]
    out["scale_units"] = arr["a"][scale]
    return out


# ---------------------------------------------------------------------------
# per-VM lifecycles / cohort rollup
# ---------------------------------------------------------------------------
def vm_lifecycle(src: LogLike, vm_id: int) -> List[dict]:
    """One VM's event timeline: ``[{t, kind, pool, host, a, b, aux}, …]``
    in emit order — submit → start → interrupt → hibernate → resume → …"""
    log = _log(src)
    arr = log.to_arrays()
    rows = np.flatnonzero(arr["vm"] == vm_id)
    kinds, auxs = arr["kinds"], arr["auxs"]
    return [{
        "t": float(arr["t"][i]), "kind": str(kinds[arr["kind"][i]]),
        "pool": int(arr["pool"][i]), "host": int(arr["host"][i]),
        "a": float(arr["a"][i]), "b": float(arr["b"][i]),
        "aux": str(auxs[arr["aux"][i]]) if arr["aux"][i] >= 0 else None,
    } for i in rows]


def cohort_summary(src: LogLike) -> dict:
    """Cohort-level rollup of the per-VM timelines: VM count, final-state
    histogram (each VM's last lifecycle event), interruption / migration
    counts per VM (total, max, mean) — the "per-VM lifecycle" answer at
    fleet scale, computed with one ``np.unique`` pass."""
    log = _log(src)
    arr = log.to_arrays()
    life = _kind_mask(arr, log, "submit", "start", "resume", "finish",
                      "fail", "interrupt", "hibernate", "terminate")
    vm = arr["vm"][life]
    if vm.size == 0:
        return {"n_vms": 0, "final_states": {}, "interruptions": {},
                "migrations": {}}
    kind = arr["kind"][life]
    uniq, inverse = np.unique(vm, return_inverse=True)
    # final state: the last lifecycle event of each VM (emit order = time
    # order, so the highest row index per VM wins)
    last = np.zeros(uniq.size, dtype=np.int64)
    np.maximum.at(last, inverse, np.arange(vm.size))
    final_kinds = kind[last]
    kinds_table = arr["kinds"]
    final_states: Dict[str, int] = {}
    for k, n in zip(*np.unique(final_kinds, return_counts=True)):
        final_states[str(kinds_table[k])] = int(n)

    def _per_vm(kind_name: str) -> dict:
        m = _kind_mask(arr, log, kind_name)
        counts = np.zeros(uniq.size)
        if m.any():
            idx = np.searchsorted(uniq, arr["vm"][m])
            ok = (idx < uniq.size)
            ok[ok] &= uniq[idx[ok]] == arr["vm"][m][ok]
            np.add.at(counts, idx[ok], 1)
        return {"total": int(counts.sum()), "max": int(counts.max()),
                "mean": round(float(counts.mean()), 4)}

    return {
        "n_vms": int(uniq.size),
        "final_states": final_states,
        "interruptions": _per_vm("interrupt"),
        "migrations": _per_vm("migrate-start"),
    }
