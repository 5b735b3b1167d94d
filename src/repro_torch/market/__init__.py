"""repro_torch.market — scenario layers above the core simulator.

A port of ``repro.market`` with the same modules, names and exports.  All
of it is host-side numpy float64 carried over from the reference, except
the offline price-path simulation, whose ``backend="torch"`` runs float64
on the GPU (``price_process.simulate_price_paths``,
``risk.simulated_price_fan``).

* ``engine``      — dynamic market engine: multi-pool price clearing +
                    vectorized interruption waves (PRICE_TICK coupling).
* ``pools``       — capacity-pool / regime configuration (calm, volatile,
                    correlated multi-pool).
* ``price_process`` — scalar price processes, array-native families, and
                    offline price paths (numpy or torch backend).
* ``bids``        — spot bid strategies (on-demand cap, percentile of
                    history, randomized per Bhuyan et al.) + adaptive
                    re-bidding on hibernation (``RebidOnResume``).
* ``pricing``     — cost accounting, realized spot billing.
* ``migration``   — proactive cross-pool migration planner (PRICE_TICK
                    scoring, MIGRATE_START/COMPLETE execution).
* ``fleet``       — spot-fleet manager: target-capacity allocation across
                    pools with a configurable fallback ladder (same-pool →
                    cheaper-pool → on-demand → queue → scale-down).
* ``faults``      — deterministic seeded market fault injection (capacity
                    crunch, price spike, pool outage, correlated storm)
                    composing with the PRICE_TICK machinery.
* ``risk``        — pool price gradients/volatility, Monte-Carlo price
                    fans, advisor-band-derived pool volatility.
* ``trace``       — Google-Cluster-Trace-style machine/task event generation,
                    CSV reading, and trace-driven simulation (paper §VII-C/D).
* ``advisor``     — synthetic AWS Spot-Instance-Advisor dataset (§VII-F).
* ``correlation`` — Theil's U / correlation ratio / Pearson association
                    measures for mixed categorical-numeric data (§VII-F).
"""
from .advisor import generate_advisor_dataset
from .bids import (
    BID_REGISTRY,
    OnDemandCapBid,
    PercentileBid,
    RandomizedBid,
    RebidOnResume,
    assign_bids,
    make_bid_strategy,
    reference_history,
    register_bid_strategy,
)
from .engine import MarketEngine, price_integral_ref
from .faults import (
    FAULT_KINDS,
    FAULT_REGISTRY,
    FaultEvent,
    FaultInjector,
    make_fault_injector,
    register_fault_scenario,
    storm_victims,
)
from .fleet import (
    FLEET_STRATEGY_REGISTRY,
    FleetConfig,
    FleetManager,
    LADDER_RUNGS,
    fleet_pool_capacity,
    fleet_pool_capacity_ref,
    make_fleet_manager,
    plan_replenish,
    plan_replenish_ref,
    register_fleet_strategy,
    validate_fleet_config,
)
from .migration import (
    MIGRATION_POLICIES,
    MIGRATION_REGISTRY,
    MigrationConfig,
    MigrationPlan,
    MigrationPlanner,
    make_migration_planner,
    plan_reference,
    register_migration_policy,
)
from .pools import MarketConfig, PoolConfig, REGIMES, make_market
from .risk import (
    advisor_pool_volatility,
    bid_crossing_risk,
    price_gradients,
    price_volatility,
    projected_prices,
    simulated_price_fan,
)
from .pricing import PriceModel, cost_stats, realized_cost_stats
from .price_process import (
    AUCTION_FAMILY,
    AuctionPrice,
    MarketState,
    PRICE_PROCESS_REGISTRY,
    SMOOTHED_FAMILY,
    ScalarProcessAdapter,
    SmoothedPrice,
    draw_shock_table,
    regime_comparison,
    register_price_process,
    simulate_price_paths,
    simulate_price_series,
)
from .correlation import (
    association_matrix,
    correlation_ratio,
    pearson,
    theils_u,
)
from .trace import (
    TraceConfig,
    generate_trace,
    load_trace,
    simulate_trace,
    wire_trace,
    write_trace_csv,
)

__all__ = [k for k in dir() if not k.startswith("_")]
