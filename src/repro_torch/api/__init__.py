"""repro_torch.api — the declarative scenario/experiment layer.

One spec tree describes a run; registries make every component pluggable;
the builder materializes fresh simulators; the sweep runner turns an
``ExperimentSpec`` into a seed-swept mean ± CI report:

    from repro_torch.api import (ExperimentSpec, MigrationSpec, PolicySpec,
                           RunSpec, ScenarioSpec, build, run_experiment)

    spec = RunSpec(
        scenario=ScenarioSpec(workload="market", regime="volatile",
                              bid={"strategy": "randomized",
                                   "params": {"lo": 0.45}}),
        policy=PolicySpec("hlem-vmp-adjusted", {"alpha": -0.5}),
        migration=MigrationSpec("gradient-aware"))
    sim = build(spec, seed=0)          # fresh components, ready to run
    metrics = sim.run(until=14400.0)

    exp = ExperimentSpec(scenario=spec.scenario,
                         policies=(spec.policy,),
                         migrations=(MigrationSpec("none"),
                                     MigrationSpec("gradient-aware")),
                         regimes=("volatile", "correlated"),
                         seeds=tuple(range(20)))
    report = run_experiment(exp)       # multiprocessing fan-out, mean ± CI

Specs JSON round-trip losslessly (``to_dict``/``from_dict``/``to_json``/
``ExperimentSpec.load``), so experiments live in files — see
``examples/specs/``.
"""
from .registry import (
    AUTOSCALE_REGISTRY,
    BID_REGISTRY,
    MIGRATION_REGISTRY,
    POLICY_REGISTRY,
    PRICE_PROCESS_REGISTRY,
    Registry,
    WORKLOAD_REGISTRY,
    WorkloadDef,
    register_autoscale_policy,
    register_bid_strategy,
    register_migration_policy,
    register_policy,
    register_price_process,
    register_workload,
)
from .specs import (
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
)
from .build import (build, build_engine, build_tracer, collect_row,
                    resolve_horizon, run_one)
from .sweep import (
    aggregate_rows,
    format_report,
    mean_ci95,
    run_experiment,
    write_report,
)

import types as _types

__all__ = [k for k, v in list(globals().items())
           if not k.startswith("_") and not isinstance(v, _types.ModuleType)]
