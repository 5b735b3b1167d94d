"""One import point for every plugin registry the scenario API validates
against.

The registries themselves live next to the families they describe (so core
stays importable without the API layer); this module re-exports them plus
the registration decorators:

* :data:`POLICY_REGISTRY` / ``register_policy`` — allocation policies.
* :data:`BID_REGISTRY` / ``register_bid_strategy`` — bid strategies.
* :data:`MIGRATION_REGISTRY` / ``register_migration_policy`` — migration
  policies.
* :data:`PRICE_PROCESS_REGISTRY` / ``register_price_process`` — pool price
  processes.
* :data:`WORKLOAD_REGISTRY` / ``register_workload`` — workload generators.
* :data:`AUTOSCALE_REGISTRY` / ``register_autoscale_policy`` — autoscaler
  policies.
"""
from ..core.registry import Registry
from ..core.allocation import POLICY_REGISTRY, register_policy
from ..market.bids import BID_REGISTRY, register_bid_strategy
from ..market.migration import MIGRATION_REGISTRY, register_migration_policy
from ..market.price_process import (
    PRICE_PROCESS_REGISTRY,
    register_price_process,
)
from ..serve.autoscale import AUTOSCALE_REGISTRY, register_autoscale_policy
from .workloads import WORKLOAD_REGISTRY, WorkloadDef, register_workload

__all__ = [
    "Registry",
    "POLICY_REGISTRY", "register_policy",
    "BID_REGISTRY", "register_bid_strategy",
    "MIGRATION_REGISTRY", "register_migration_policy",
    "PRICE_PROCESS_REGISTRY", "register_price_process",
    "WORKLOAD_REGISTRY", "WorkloadDef", "register_workload",
    "AUTOSCALE_REGISTRY", "register_autoscale_policy",
]
