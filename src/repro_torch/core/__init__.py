"""repro_torch.core — the paper's contribution: dynamic spot-market simulation.

Public API:
  MarketSimulator, SimConfig — discrete-event spot-market engine (§V)
  allocation policies        — FirstFit/BestFit/WorstFit/HLEM-VMP/adjusted (§VI)
  hlem scoring               — numpy oracle + torch/CUDA kernel (Eqs. 1-11)
  workload generators        — §VII-E synthetic scenario, random fleets
  metrics & table builders   — §V-E reporting
"""
from .allocation import (
    AllocationPolicy,
    BestFit,
    FirstFit,
    HlemVmp,
    HlemVmpAdjusted,
    POLICIES,
    POLICY_REGISTRY,
    WorstFit,
    clearing_mask,
    direct_mask,
    make_policy,
    register_policy,
)
from .registry import Registry
from .hlem import (
    hlem_scores_batch_np,
    hlem_scores_batch_torch,
    hlem_scores_np,
    hlem_scores_torch,
    hlem_select_batch_torch,
    hlem_select_np,
    hlem_select_torch,
    hlem_weights_np,
    rsdiff_np,
)
from .hosts import HostPool
from .metrics import (
    InterruptionEvent,
    Metrics,
    MigrationEvent,
    WaveEvent,
    dynamic_vm_table,
    execution_table,
    spot_vm_table,
    to_csv,
    to_json,
)
from .simulator import MarketSimulator, SimConfig
from .types import (
    InterruptionBehavior,
    N_DIMS,
    RESOURCE_DIMS,
    Vm,
    VmState,
    VmType,
    make_on_demand,
    make_spot,
    resources,
)
from .workload import (
    HOST_COUNTS,
    HOST_TYPES,
    VM_PROFILES,
    MarketScenarioConfig,
    ScenarioConfig,
    build_hosts,
    market_scenario,
    random_fleet,
    random_vms,
    synthetic_scenario,
)

__all__ = [k for k in dir() if not k.startswith("_")]
