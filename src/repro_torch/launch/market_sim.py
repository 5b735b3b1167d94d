"""Market simulation launcher (the paper's §VII experiments from the CLI).

  python -m repro_torch.launch.market_sim --scenario synthetic --policy all
  python -m repro_torch.launch.market_sim --scenario trace --machines 200
  python -m repro_torch.launch.market_sim --market                 # price regimes
  python -m repro_torch.launch.market_sim --market --regimes volatile --pools 3

``--market`` runs the dynamic market engine: multi-pool price clearing over
the market scenario, HLEM vs First-Fit under calm / volatile /
correlated-pool price regimes, reporting interruption counts, max
interruption duration, and realized spot cost (billed at clearing price).

``--migration=POLICY`` (or ``all``) attaches the proactive cross-pool
migration planner and reports migrations / downtime / savings next to the
interruption metrics:

  python -m repro_torch.launch.market_sim --market --migration all
  python -m repro_torch.launch.market_sim --market --migration gradient-aware \\
      --regimes volatile,correlated --rebid

``--fleet STRATEGY`` attaches the spot-fleet manager (target capacity held
through a fallback ladder), ``--faults SCENARIO`` injects a seeded market
fault scenario, and ``--fleet compare --sweep N`` runs the fleet-vs-per-VM
resilience comparison:

  python -m repro_torch.launch.market_sim --market --fleet diversified \\
      --faults storm
  python -m repro_torch.launch.market_sim --market --regimes volatile \\
      --fleet compare --faults storm --sweep 10 \\
      --report results/sweep/fleet_resilience.json

``--serve CURVE`` runs the traffic-driven serving scenario: a demand curve
(``diurnal`` or ``bursty``) feeds a request queue served on the spot
fleet's live VMs, and the row reports SLO attainment, latency percentiles,
error-budget burn, and cost per served request.  ``--autoscale POLICY``
closes the loop (static, target-tracking, step, predictive-from-curve);
``--autoscale compare --sweep N`` sweeps target-tracking against the
static baseline:

  python -m repro_torch.launch.market_sim --serve diurnal --fleet-target 24 \\
      --autoscale target-tracking
  python -m repro_torch.launch.market_sim --serve diurnal --regimes volatile \\
      --faults storm --fleet-target 24 --autoscale compare --sweep 10 \\
      --report results/sweep/serve_slo_sweep.json

Every mode routes through the declarative scenario API
(:mod:`repro_torch.api`): the CLI flags assemble a spec tree, ``api.build``
materializes fresh components per run.  Two spec-file modes make whole
experiments shareable artifacts:

  # seed sweep of the --market grid: mean ± 95% CI over N seeds per cell
  python -m repro_torch.launch.market_sim --market --migration all --sweep 20 \\
      --report results/migration_sweep.json

  # run an ExperimentSpec JSON file directly (see examples/specs/)
  python -m repro_torch.launch.market_sim --spec examples/specs/migration_sweep.json

Observability (single-run modes): ``--trace-out trace.json`` writes a
Chrome trace-event file, ``--profile`` / ``--profile-out`` aggregate the
per-subsystem self/total wall-time table, ``--counters-every 600`` prints a
live counter line per 600 s of sim time.  Tracing is observation-only —
the metrics rows are identical with and without it:

  python -m repro_torch.launch.market_sim --market --regimes volatile \\
      --policy hlem-vmp-adjusted --trace-out results/profile/trace.json \\
      --profile --counters-every 600

The event flight recorder (``--events-out``) writes a structured log of
every lifecycle/market event (NDJSON or ``.npz`` by extension);
``--report-html`` renders a self-contained HTML run report, and
``--diff A B`` compares two recorded logs and reports the first
divergence (exit 1 when the runs diverge):

  python -m repro_torch.launch.market_sim --market --regimes volatile \\
      --policy hlem-vmp-adjusted --events-out run.ndjson \\
      --report-html run.html
  python -m repro_torch.launch.market_sim --diff run_a.ndjson run_b.ndjson

Live progress lines (counter snapshots, per-cell sweep progress) are
suppressed when stderr is not a terminal (e.g. under CI or redirection);
``--force-progress`` restores them.

The HLEM policies (``hlem-vmp``, ``hlem-vmp-adjusted``) score hosts on
``--device``: ``cuda`` (the default) launches the hand-written HLEM
kernel, ``cpu`` runs its plain PyTorch version.  The flag sets the
``device`` parameter of every HLEM policy the run builds, and of each
HLEM policy in a ``--spec`` file that states no ``device`` of its own (a
file's ``device`` wins); a policy whose params ask for ``"backend": "numpy"``
runs the float64 numpy oracle and ignores it.  ``--device cuda`` on a
machine without a card raises when the first HLEM policy is built:

  python -m repro_torch.launch.market_sim --market --device cpu
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

from ..api import (
    POLICY_REGISTRY,
    AutoscaleSpec,
    BidSpec,
    ExperimentSpec,
    FaultSpec,
    FleetSpec,
    MigrationSpec,
    ObsSpec,
    PolicySpec,
    RebidSpec,
    RunSpec,
    ScenarioSpec,
    ServeSpec,
    collect_row,
    format_report,
    resolve_horizon,
    run_experiment,
    run_one,
)
from ..api import build as build_run
from ..market import MIGRATION_POLICIES, REGIMES
from ..obs import format_profile_table, run_manifest, write_chrome_trace
from ..obs import write_profile
from ..obs import first_divergence, format_divergence, write_html_report

POLICY_SET = ["first-fit", "best-fit", "worst-fit", "hlem-vmp",
              "hlem-vmp-adjusted"]
MARKET_POLICY_SET = ["first-fit", "hlem-vmp-adjusted"]


def _takes_device(name: str) -> bool:
    """Whether the policy registered as ``name`` scores on a torch device
    (takes a ``device`` parameter: the HLEM policies)."""
    return "device" in inspect.signature(POLICY_REGISTRY.get(name)).parameters


def _policy_spec(name: str, alpha: float = -0.5,
                 device: str = "cuda") -> PolicySpec:
    params = {"alpha": alpha} if name == "hlem-vmp-adjusted" else {}
    if _takes_device(name):
        params["device"] = device
    return PolicySpec(name, params)


def _on_device(exp: ExperimentSpec, device: str) -> ExperimentSpec:
    """``exp`` with ``device`` set on every policy that takes one and does
    not state its own: a spec file's ``device`` wins over the flag."""
    return exp.replace(policies=tuple(
        PolicySpec(p.name, {"device": device, **p.params})
        if _takes_device(p.name) else p for p in exp.policies))


def _market_scenario_spec(regime: str, n_pools: int = 4,
                          bid_strategy: str = "randomized",
                          tick_interval: float = 60.0,
                          from_advisor: bool = True,
                          horizon: float | None = None) -> ScenarioSpec:
    """The ``--market`` scenario as a spec: regional demand humps over
    long-lived pool-flexible spot VMs, per-pool advisor volatility, seeded
    bids.  Randomized bids are floored above the busy-fleet clearing base,
    so draws span the at-risk band instead of the permanently-below-base
    region."""
    bid_params = {"lo": 0.45} if bid_strategy == "randomized" else {}
    return ScenarioSpec(
        workload="market", regime=regime, n_pools=n_pools,
        tick_interval=tick_interval, from_advisor=from_advisor,
        bid=BidSpec(bid_strategy, bid_params), horizon=horizon)


def _progress_enabled(args) -> bool:
    """Live stderr progress (counter lines, per-cell sweep lines) is for
    humans watching a terminal: suppressed under ``--json`` and whenever
    stderr is not a TTY (CI logs, redirection), unless ``--force-progress``
    overrides."""
    if args.json:
        return False
    return bool(args.force_progress or sys.stderr.isatty())


def _live_counter_line(sim_t: float, snap: dict) -> None:
    """The counter tracer's live progress line (stderr — stdout stays a
    pure document for --json consumers)."""
    running = int(snap.get("gauge/running_spot", 0)
                  + snap.get("gauge/running_od", 0))
    intr = int(sum(v for k, v in snap.items()
                   if k.startswith("interruptions/")))
    print(f"# t={sim_t:9.0f}s  events={int(snap.get('events/total', 0)):8d}"
          f"  running={running:6d}"
          f"  waiting={int(snap.get('gauge/waiting', 0)):6d}"
          f"  hibernated={int(snap.get('gauge/hibernated', 0)):5d}"
          f"  queue={int(snap.get('gauge/queue_depth', 0)):6d}"
          f"  interruptions={intr:6d}",
          file=sys.stderr, flush=True)


def _emit_obs_artifacts(sim, spec: RunSpec, seed: int, args,
                        duration_s: float) -> dict:
    """Write/print the run's observability artifacts per the CLI flags;
    returns the extra blocks (counters) to merge into a JSON document."""
    tr = sim.obs
    evl = sim.events
    if not (tr.enabled or evl.enabled):
        return {}
    man = run_manifest(spec_dict=spec.to_dict(), seed=seed,
                       duration_s=duration_s)
    if args.trace_out:
        write_chrome_trace(tr, args.trace_out, manifest=man)
        print(f"# wrote {args.trace_out}", file=sys.stderr)
    if args.profile_out:
        write_profile(tr, args.profile_out, manifest=man)
        print(f"# wrote {args.profile_out}", file=sys.stderr)
    if args.profile and tr.enabled:
        print(format_profile_table(tr), file=sys.stderr)
    if args.events_out and evl.enabled:
        evl.save(args.events_out, manifest=man)
        print(f"# wrote {args.events_out}", file=sys.stderr)
    if args.report_html and evl.enabled:
        write_html_report(evl, args.report_html, manifest=man)
        print(f"# wrote {args.report_html}", file=sys.stderr)
    extra = {}
    if args.counters_every and tr.enabled:
        extra["counters"] = {
            "every": args.counters_every,
            "series": [{"t": round(t, 3), "values": snap}
                       for t, _wall, snap in tr.counters.series],
            "final": dict(tr.counters.values),
        }
    return extra


def _run_one_obs(spec: RunSpec, seed: int, until, args, sink: dict) -> dict:
    """Single-run unit with a live tracer: build, attach the live counter
    line, run, collect the standard row, then emit trace/profile/counters
    artifacts.  The metrics row is identical to :func:`repro_torch.api.run_one`
    (tracing is observation-only)."""
    sim = build_run(spec, seed)
    if args.counters_every and _progress_enabled(args):
        sim.obs.on_snapshot = _live_counter_line
    horizon = until if until is not None else resolve_horizon(spec.scenario)
    t0 = time.time()
    metrics = sim.run(until=horizon)
    wall = time.time() - t0
    row = collect_row(sim, metrics, spec, seed)
    row["wall_s"] = round(wall, 1)
    sink.update(_emit_obs_artifacts(sim, spec, seed, args, wall))
    return row


def run_synthetic(policy_name: str, seed: int, until: float,
                  selector: str = "list_order", alpha: float = -0.5,
                  obs: ObsSpec | None = None, cli_args=None,
                  obs_sink: dict | None = None,
                  device: str = "cuda") -> dict:
    """One §VII-E synthetic run through the scenario API."""
    spec = RunSpec(
        scenario=ScenarioSpec(
            workload="synthetic",
            sim_params={"interruption_selector": selector}),
        policy=_policy_spec(policy_name, alpha, device),
        obs=obs)
    if obs is not None and obs.enabled:
        return _run_one_obs(spec, seed, until, cli_args,
                            obs_sink if obs_sink is not None else {})
    t0 = time.time()
    stats = run_one(spec, seed, until=until)
    stats["wall_s"] = round(time.time() - t0, 1)
    return stats


def run_market(policy_name: str, regime: str, seed: int, until: float = 14400.0,
               n_pools: int = 4, bid_strategy: str = "randomized",
               tick_interval: float = 60.0, alpha: float = -0.5,
               migration: str = "none", rebid: bool = False,
               from_advisor: bool = True, fleet: FleetSpec | None = None,
               faults: FaultSpec | None = None,
               obs: ObsSpec | None = None, cli_args=None,
               obs_sink: dict | None = None, device: str = "cuda") -> dict:
    """One engine-coupled run over the market scenario through the scenario
    API (fresh engine/planner per call; ``migration="none"`` is
    bit-identical to no planner; ``rebid`` switches on adaptive re-bidding
    on hibernation; ``fleet``/``faults`` attach the resilience layer;
    ``obs`` attaches the telemetry tracer — metrics rows are identical
    either way)."""
    spec = RunSpec(
        scenario=_market_scenario_spec(regime, n_pools, bid_strategy,
                                       tick_interval, from_advisor),
        policy=_policy_spec(policy_name, alpha, device),
        migration=MigrationSpec(migration),
        rebid=RebidSpec() if rebid else None,
        fleet=fleet, faults=faults, obs=obs)
    if obs is not None and obs.enabled:
        return _run_one_obs(spec, seed, until, cli_args,
                            obs_sink if obs_sink is not None else {})
    t0 = time.time()
    row = run_one(spec, seed, until=until)
    row["wall_s"] = round(time.time() - t0, 1)
    return row


def _serve_scenario_spec(args, regime: str, until: float) -> ScenarioSpec:
    wl_params = {}
    if args.serve_rate is not None:
        wl_params["base_rate"] = args.serve_rate
    return ScenarioSpec(
        workload=f"serve-{args.serve}", regime=regime, n_pools=args.pools,
        tick_interval=args.tick, from_advisor=not args.flat_volatility,
        horizon=until, workload_params=wl_params)


def _serve_run_spec(args, regime: str, policy: str,
                    autoscale: AutoscaleSpec | None, until: float,
                    obs: ObsSpec | None = None) -> RunSpec:
    return RunSpec(
        scenario=_serve_scenario_spec(args, regime, until),
        policy=_policy_spec(policy, args.alpha, args.device),
        fleet=FleetSpec(strategy=args.fleet or "diversified",
                        params={"target_capacity": args.fleet_target}),
        faults=FaultSpec(scenario=args.faults) if args.faults else None,
        serve=ServeSpec(), autoscale=autoscale, obs=obs)


def _print_serve_rows(rows, labels) -> None:
    print(f"{'regime':11s} {'autoscale':22s} {'arrived':>8s} {'done':>8s} "
          f"{'requeue':>7s} {'p95_s':>9s} {'slo':>6s} {'burn':>6s} "
          f"{'$/req':>9s} {'od_spill':>8s}")
    for lb, r in zip(labels, rows):
        print(f"{r['regime']:11s} {lb:22s} "
              f"{r['requests_arrived']:8d} {r['requests_done']:8d} "
              f"{r['requests_requeued']:7d} {r['p95_latency_s']:9.1f} "
              f"{r['slo_attainment']:6.3f} {r['error_budget_burn']:6.2f} "
              f"{r['cost_per_request']:9.5f} {r['od_spill_cost']:8.3f}")


def run_serve(args, obs_spec, ap, t_main: float) -> int:
    """The ``--serve`` mode: single runs per regime, or (with ``--sweep``)
    a seed-swept regime × autoscale-policy grid through
    :func:`repro_torch.api.run_experiment`."""
    until = args.until if args.until is not None else 14400.0
    regimes = args.regimes.split(",")
    policy = args.policy if args.policy != "all" else "first-fit"
    if args.autoscale == "compare" and not args.sweep:
        ap.error("--autoscale compare requires --sweep N")

    if args.sweep:
        if args.autoscale == "compare":
            autoscales = (AutoscaleSpec("static"),
                          AutoscaleSpec("target-tracking"))
        elif args.autoscale:
            autoscales = (AutoscaleSpec(args.autoscale),)
        else:
            autoscales = None
        exp = ExperimentSpec(
            name=f"serve_sweep_{args.sweep}x",
            scenario=_serve_scenario_spec(args, regimes[0], until),
            policies=(_policy_spec(policy, args.alpha, args.device),),
            regimes=tuple(regimes),
            seeds=tuple(range(args.seed, args.seed + args.sweep)),
            fleets=(FleetSpec(strategy=args.fleet or "diversified",
                              params={"target_capacity": args.fleet_target}),),
            faults=FaultSpec(scenario=args.faults) if args.faults else None,
            serve=ServeSpec(), autoscales=autoscales)
        return _sweep_and_report(exp, args)

    if obs_spec is not None and len(regimes) > 1:
        ap.error("observability flags trace a single run — pick one "
                 "--regimes value")
    autoscale = AutoscaleSpec(args.autoscale) if args.autoscale else None
    label = args.autoscale or "none"
    rows, obs_sink = [], {}
    for regime in regimes:
        spec = _serve_run_spec(args, regime, policy, autoscale, until,
                               obs=obs_spec)
        if obs_spec is not None and obs_spec.enabled:
            row = _run_one_obs(spec, args.seed, until, args, obs_sink)
        else:
            t0 = time.time()
            row = run_one(spec, args.seed, until=until)
            row["wall_s"] = round(time.time() - t0, 1)
        rows.append(row)
    if args.json:
        doc = {"rows": rows, "manifest": _cli_manifest(args, t_main)}
        doc.update(obs_sink)
        print(json.dumps(doc, indent=1))
    else:
        _print_serve_rows(rows, [label] * len(rows))
    return 0


def run_sanitized(args) -> int:
    """One fixed-seed run inside :func:`repro_torch.obs.sanitized` — wall-clock
    and global-RNG calls raise anywhere on the sim path, verifying at
    runtime what detlint's ``no-wallclock``/``no-global-rng`` rules claim
    statically.  Spec construction and ``build_run`` happen *outside* the
    scope (building draws from seeded Generators, which stay allowed);
    only the event loop itself runs sanitized."""
    from ..obs.sanitize import sanitized
    if args.market:
        regime = args.regimes.split(",")[0]
        policy = args.policy if args.policy != "all" else "hlem-vmp-adjusted"
        migration = args.migration.split(",")[0]
        spec = RunSpec(
            scenario=_market_scenario_spec(regime, args.pools,
                                           args.bid_strategy, args.tick,
                                           not args.flat_volatility),
            policy=_policy_spec(policy, args.alpha, args.device),
            migration=MigrationSpec("none" if migration == "all"
                                    else migration),
            rebid=RebidSpec() if args.rebid else None,
            fleet=(FleetSpec(strategy=args.fleet,
                             params={"target_capacity": args.fleet_target})
                   if args.fleet and args.fleet != "compare" else None),
            faults=FaultSpec(scenario=args.faults) if args.faults else None)
        until = args.until if args.until is not None else 14400.0
    else:
        policy = args.policy if args.policy != "all" else "first-fit"
        spec = RunSpec(
            scenario=ScenarioSpec(
                workload="synthetic",
                sim_params={"interruption_selector": args.selector}),
            policy=_policy_spec(policy, args.alpha, args.device))
        until = args.until if args.until is not None else 3000.0
    sim = build_run(spec, args.seed)
    with sanitized():
        metrics = sim.run(until=until)
    row = collect_row(sim, metrics, spec, args.seed)
    row["sanitized"] = True
    if args.json:
        print(json.dumps({"rows": [row]}, indent=1))
    else:
        print(f"# sanitized run ok: seed={args.seed} until={until} "
              f"policy={row.get('policy')} — no wall-clock or global-RNG "
              "calls on the sim path")
    return 0


def _cli_manifest(args, t0: float) -> dict:
    """The provenance block for CLI-assembled (possibly multi-row) runs:
    the manifest's spec dict is the parsed CLI namespace, so the hash
    pins the exact flag combination that produced the document."""
    return run_manifest(spec_dict=dict(sorted(vars(args).items())),
                        seed=args.seed, duration_s=time.time() - t0)


def _print_market_rows(rows) -> None:
    fleet = any("time_below_target_s" in r for r in rows)
    print(f"{'regime':11s} {'policy':18s} {'migration':15s} "
          f"{'intr':>5s} {'waves':>5s} {'max_intr_s':>10s} "
          f"{'migr':>5s} {'down_s':>7s} {'spot_cost':>9s} "
          f"{'save%':>6s} {'waste':>7s}"
          + (f" {'below_tgt_s':>11s} {'recov_s':>8s} {'od_spill':>8s}"
             if fleet else ""))
    for r in rows:
        line = (f"{r['regime']:11s} {r['policy']:18s} "
                f"{r['migration']:15s} "
                f"{r['interruptions']:5d} {r['waves']:5d} "
                f"{r['max_interruption_time']:10.1f} "
                f"{r['migrations']:5d} "
                f"{r['migration_downtime_s']:7.1f} "
                f"{r['realized_spot_cost']:9.3f} "
                f"{r['savings_pct']:6.1f} {r['wasted_cost']:7.3f}")
        if "time_below_target_s" in r:
            line += (f" {r['time_below_target_s']:11.1f} "
                     f"{r['mean_recovery_s']:8.1f} "
                     f"{r['od_spill_launches']:8d}")
        print(line)


def _sweep_and_report(exp: ExperimentSpec, args) -> int:
    # report_path flushes the report after every completed cell (atomic
    # rename) and resumes from a matching partial report after a crash;
    # --fresh discards any checkpoint (e.g. after changing simulator code)
    report = run_experiment(exp, processes=args.workers,
                            progress=_progress_enabled(args),
                            report_path=args.report or None,
                            resume=not args.fresh, manifest=True)
    if args.report:
        # stderr keeps --json stdout a pure JSON document
        print(f"# wrote {args.report}", file=sys.stderr)
    if args.report_html:
        write_html_report(report, args.report_html)
        print(f"# wrote {args.report_html}", file=sys.stderr)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        print(format_report(report))
    return 0


def _diff_logs(path_a: str, path_b: str) -> int:
    """Standalone ``--diff A B`` mode: stream two recorded event logs,
    report the first divergence (with context) or confirm zero divergence.
    Exit status 1 when the runs diverge — scriptable as a bit-identity
    gate."""
    div = first_divergence(path_a, path_b)
    print(format_divergence(div, label_a=path_a, label_b=path_b))
    return 0 if div is None else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", choices=["synthetic", "trace"],
                    default="synthetic")
    ap.add_argument("--policy", default="all",
                    help="policy name or 'all'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--until", type=float, default=None,
                    help="horizon (s); default 3000, or 14400 in "
                         "--market mode (the four demand humps + drain)")
    ap.add_argument("--selector", default="list_order",
                    choices=["list_order", "best_fit_remaining",
                             "max_progress"])
    ap.add_argument("--alpha", type=float, default=-0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device the HLEM policies score on: cuda "
                         "(the hand-written kernel) or cpu (its plain "
                         "PyTorch version); a --spec file's own device "
                         "param wins")
    ap.add_argument("--machines", type=int, default=200)
    ap.add_argument("--spot", type=int, default=1000)
    ap.add_argument("--days", type=float, default=0.25)
    ap.add_argument("--json", action="store_true")
    # observability (single-run modes; see README "Observability")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run here "
                         "(open in chrome://tracing or Perfetto); single-run "
                         "modes only")
    ap.add_argument("--profile", action="store_true",
                    help="aggregate span wall-times and print the "
                         "per-subsystem self/total table to stderr")
    ap.add_argument("--profile-out", default="",
                    help="write the profile report JSON here "
                         "(implies --profile aggregation)")
    ap.add_argument("--counters-every", type=float, default=None,
                    metavar="SECS",
                    help="snapshot live counters every SECS of sim time; "
                         "prints a progress line per snapshot to stderr "
                         "(suppressed under --json; the series lands in the "
                         "JSON document instead)")
    ap.add_argument("--events-out", default="",
                    help="record the structured event flight log and write "
                         "it here (NDJSON, or compressed .npz by "
                         "extension); single-run modes only")
    ap.add_argument("--report-html", default="",
                    help="write a self-contained HTML report here: per-run "
                         "price/risk/occupancy charts (records the event "
                         "log), or the aggregate comparison in sweep modes")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="standalone mode: diff two recorded event logs "
                         "and report the first divergence (exit 1 when the "
                         "runs diverge)")
    ap.add_argument("--sanitize", action="store_true",
                    help="run one fixed-seed run with the runtime determinism "
                         "sanitizer armed: time.time/random.*/legacy "
                         "np.random.* raise inside the sim scope (the dynamic "
                         "twin of tools/detlint's no-wallclock/no-global-rng)")
    ap.add_argument("--force-progress", action="store_true",
                    help="emit live stderr progress lines even when stderr "
                         "is not a terminal (they are suppressed by default "
                         "under redirection/CI)")
    # market-engine mode
    ap.add_argument("--market", action="store_true",
                    help="run the dynamic market engine across price regimes")
    ap.add_argument("--regimes", default="calm,volatile,correlated",
                    help="comma-separated subset of " + ",".join(REGIMES))
    ap.add_argument("--pools", type=int, default=4)
    ap.add_argument("--bid-strategy", default="randomized",
                    choices=["on-demand-cap", "percentile", "randomized"])
    ap.add_argument("--tick", type=float, default=60.0,
                    help="price tick interval (s)")
    ap.add_argument("--migration", default="none",
                    help="proactive migration policy: a comma-separated "
                         "subset of " + ",".join(MIGRATION_POLICIES)
                         + ", or 'all' to compare every policy per regime")
    ap.add_argument("--rebid", action="store_true",
                    help="adaptive re-bidding on hibernation (Bhuyan-style)")
    ap.add_argument("--fleet", default="",
                    help="attach a spot-fleet manager: a fleet strategy "
                         "name (diversified, lowest-price, single-pool), or "
                         "'compare' to sweep the diversified fleet against "
                         "the per-VM baseline (sweep mode only)")
    ap.add_argument("--fleet-target", type=float, default=64.0,
                    help="fleet target capacity in CPU cores (with --fleet)")
    ap.add_argument("--faults", default="",
                    help="inject a registered fault scenario (storm, "
                         "random-storms, pool-outage, price-spike, "
                         "capacity-crunch, scripted)")
    # serving-scenario mode
    ap.add_argument("--serve", default="", choices=["", "diurnal", "bursty"],
                    help="run the traffic-driven serving scenario on the "
                         "named demand curve: requests queue against the "
                         "spot fleet's live capacity and the row reports "
                         "SLO/latency/cost-per-request metrics")
    ap.add_argument("--serve-rate", type=float, default=None,
                    metavar="REQ_S",
                    help="demand-curve base arrival rate in req/s "
                         "(default: the workload's registered default)")
    ap.add_argument("--autoscale", default="",
                    help="close the serving loop with an autoscale policy "
                         "(static, target-tracking, step, "
                         "predictive-from-curve), or 'compare' to sweep "
                         "target-tracking against the static baseline "
                         "(requires --sweep N)")
    ap.add_argument("--flat-volatility", action="store_true",
                    help="use the regime's hand-set volatility constant for "
                         "every pool instead of deriving per-pool sigmas "
                         "from the synthetic Spot-Advisor dataset")
    # declarative / sweep modes
    ap.add_argument("--sweep", type=int, default=0, metavar="N",
                    help="seed-swept evaluation: run the --market grid over "
                         "N seeds (seed..seed+N-1) and report mean ± 95%% CI "
                         "per regime × policy × migration cell")
    ap.add_argument("--spec", default="",
                    help="run an ExperimentSpec JSON file (overrides every "
                         "scenario flag; see examples/specs/)")
    ap.add_argument("--report", default="",
                    help="write the sweep's aggregate report JSON here "
                         "(flushed after every completed cell; a matching "
                         "partial report at this path is resumed)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing report at --report instead of "
                         "resuming from it (use after code changes: resumed "
                         "cells reflect the run that produced them)")
    ap.add_argument("--workers", type=int, default=None,
                    help="sweep worker processes (default: cpu count; "
                         "0 = serial)")
    args = ap.parse_args(argv)

    if args.diff is not None:
        return _diff_logs(*args.diff)
    if args.sanitize:
        if args.sweep or args.spec:
            ap.error("--sanitize applies to a single fixed-seed run "
                     "(not --sweep/--spec)")
        return run_sanitized(args)
    if args.serve and args.market:
        ap.error("--serve and --market are separate modes — pick one")
    if args.autoscale and not args.serve:
        ap.error("--autoscale requires --serve CURVE")
    if args.sweep and not (args.market or args.serve or args.spec):
        ap.error("--sweep requires --market or --serve "
                 "(or use --spec FILE)")
    if (args.fleet or args.faults) and not (args.market or args.serve):
        ap.error("--fleet/--faults require --market or --serve")
    if args.report and not (args.sweep or args.spec):
        ap.error("--report only applies to sweep modes "
                 "(--sweep N or --spec FILE)")
    obs_spec = None
    sweep_mode = bool(args.sweep or args.spec)
    if (args.trace_out or args.profile or args.profile_out
            or args.counters_every is not None or args.events_out):
        if sweep_mode:
            ap.error("--trace-out/--profile/--profile-out/--counters-every/"
                     "--events-out apply to single runs only "
                     "(not --sweep/--spec)")
    # --report-html doubles as the sweep's aggregate report; in single-run
    # modes it records the event log like --events-out
    want_events = bool(args.events_out
                       or (args.report_html and not sweep_mode))
    if (args.trace_out or args.profile or args.profile_out
            or args.counters_every is not None or want_events):
        obs_spec = ObsSpec(trace=bool(args.trace_out),
                           profile=bool(args.profile or args.profile_out),
                           counters_every=args.counters_every,
                           events=want_events)
    t_main = time.time()

    if args.spec:
        return _sweep_and_report(
            _on_device(ExperimentSpec.load(args.spec), args.device), args)

    if args.serve:
        if args.fleet == "compare":
            ap.error("--fleet compare is a --market sweep mode")
        return run_serve(args, obs_spec, ap, t_main)

    if args.market:
        # the migration comparison varies the migration policy against the
        # paper's allocator; the allocator comparison spans both
        policies = ((MARKET_POLICY_SET if args.migration == "none"
                     else ["hlem-vmp-adjusted"])
                    if args.policy == "all" else [args.policy])
        migrations = (list(MIGRATION_POLICIES) if args.migration == "all"
                      else args.migration.split(","))
        until = args.until if args.until is not None else 14400.0
        regimes = args.regimes.split(",")
        # the resilience layer: --fleet names a strategy ("compare" sweeps
        # fleet vs the per-VM baseline), --faults a fault scenario; both
        # fail fast at spec construction on unknown names
        faults = FaultSpec(scenario=args.faults) if args.faults else None
        fleet = None
        if args.fleet and args.fleet != "compare":
            fleet = FleetSpec(strategy=args.fleet,
                              params={"target_capacity": args.fleet_target})

        if args.sweep:
            fleets = None
            if args.fleet == "compare":
                fleets = (None, FleetSpec(
                    strategy="diversified",
                    params={"target_capacity": args.fleet_target}))
            elif fleet is not None:
                fleets = (fleet,)
            exp = ExperimentSpec(
                name=f"market_sweep_{args.sweep}x",
                scenario=_market_scenario_spec(
                    regimes[0], args.pools, args.bid_strategy, args.tick,
                    not args.flat_volatility, horizon=until),
                policies=tuple(_policy_spec(p, args.alpha, args.device)
                               for p in policies),
                migrations=tuple(MigrationSpec(m) for m in migrations),
                regimes=tuple(regimes),
                seeds=tuple(range(args.seed, args.seed + args.sweep)),
                rebid=RebidSpec() if args.rebid else None,
                fleets=fleets, faults=faults)
            return _sweep_and_report(exp, args)

        if args.fleet == "compare":
            ap.error("--fleet compare requires --sweep N")
        if obs_spec is not None and (len(regimes) > 1 or len(policies) > 1
                                     or len(migrations) > 1):
            ap.error("observability flags trace a single run — pick one "
                     "regime × policy × migration cell (e.g. --regimes "
                     "volatile --policy hlem-vmp-adjusted --migration none)")
        rows = []
        obs_sink: dict = {}
        for regime in regimes:
            for p in policies:
                for mig in migrations:
                    rows.append(run_market(
                        p, regime, args.seed, until,
                        n_pools=args.pools,
                        bid_strategy=args.bid_strategy,
                        tick_interval=args.tick, alpha=args.alpha,
                        migration=mig, rebid=args.rebid,
                        from_advisor=not args.flat_volatility,
                        fleet=fleet, faults=faults,
                        obs=obs_spec, cli_args=args, obs_sink=obs_sink,
                        device=args.device))
        if args.json:
            doc = {"rows": rows, "manifest": _cli_manifest(args, t_main)}
            doc.update(obs_sink)
            print(json.dumps(doc, indent=1))
        else:
            _print_market_rows(rows)
        return 0

    if args.scenario == "synthetic":
        policies = POLICY_SET if args.policy == "all" else [args.policy]
        if obs_spec is not None and len(policies) > 1:
            ap.error("observability flags trace a single run — pick one "
                     "--policy")
        until = args.until if args.until is not None else 3000.0
        obs_sink: dict = {}
        rows = [run_synthetic(p, args.seed, until, args.selector,
                              args.alpha, obs=obs_spec, cli_args=args,
                              obs_sink=obs_sink, device=args.device)
                for p in policies]
        if args.json:
            doc = {"rows": rows, "manifest": _cli_manifest(args, t_main)}
            doc.update(obs_sink)
            print(json.dumps(doc, indent=1))
        else:
            for r in rows:
                print(f"{r['policy']:20s} interruptions={r['interruptions']:5d} "
                      f"avg={r['avg_interruption_time']:7.2f}s "
                      f"max={r['max_interruption_time']:7.2f}s "
                      f"finished={r['spot_finished']:4d} "
                      f"terminated={r['spot_terminated']:4d} "
                      f"[{r['wall_s']}s]")
        return 0

    # trace scenario — same SimConfig wiring as every other path: one
    # ScenarioSpec, materialized by api.build
    spec = RunSpec(
        scenario=ScenarioSpec(
            workload="trace",
            workload_params={"n_machines": args.machines,
                             "sim_days": args.days, "n_spot": args.spot}),
        policy=_policy_spec(
            args.policy if args.policy != "all" else "hlem-vmp-adjusted",
            args.alpha, args.device),
        obs=obs_spec)
    t0 = time.time()
    sim = build_run(spec, args.seed)
    if args.counters_every is not None and _progress_enabled(args):
        sim.obs.on_snapshot = _live_counter_line
    metrics = sim.run(until=args.until)
    wall = time.time() - t0
    stats = collect_row(sim, metrics, spec, args.seed)
    stats.update(machines=args.machines, n_vms=len(sim.vms),
                 wall_s=round(wall, 1))
    stats.update(_emit_obs_artifacts(sim, spec, args.seed, args, wall))
    stats["manifest"] = run_manifest(spec_dict=spec.to_dict(),
                                     seed=args.seed, duration_s=wall)
    print(json.dumps(stats, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
