"""Cost accounting for simulated marketspaces (beyond-paper extension).

The paper motivates spot instances by their up-to-90 % discounts (§II-B) and
frames the contribution as insight into "cost–performance trade-offs within
volatile cloud markets" (§III), but does not quantify cost. This module
prices each VM's execution history with an on-demand rate model (linear in
resources, AWS-like coefficients) and a configurable spot discount, yielding
per-policy cost/savings/waste metrics:

* ``cost``        — Σ interval_duration × rate(demand) × (discount if spot)
* ``od_equiv``    — the same execution billed at on-demand rates
* ``wasted_cost`` — spend on work that was lost (TERMINATED spot VMs pay for
  their partial execution but deliver nothing — the hidden price of
  interruptions that hibernation avoids)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

import numpy as np

from ..core.types import Vm, VmState, VmType


@dataclass(frozen=True)
class PriceModel:
    """$ per resource-hour (AWS-like: CPU-dominated, memory secondary)."""
    per_cpu_hour: float = 0.0425        # ~m5 on-demand per vCPU
    per_gb_ram_hour: float = 0.0057
    per_gbps_bw_hour: float = 0.01
    per_tb_storage_hour: float = 0.05
    spot_discount: float = 0.30         # spot pays 30% of on-demand (70% off)

    def rate(self, demand: np.ndarray) -> float:
        """on-demand $/hour for a resource vector (cpu, ram MB, bw Mbps,
        storage MB)."""
        cpu, ram, bw, st = (float(x) for x in demand)
        return (cpu * self.per_cpu_hour
                + ram / 1024.0 * self.per_gb_ram_hour
                + bw / 1000.0 * self.per_gbps_bw_hour
                + st / 1_048_576.0 * self.per_tb_storage_hour)

    def vm_cost(self, vm: Vm) -> float:
        hours = sum((i.stop - i.start) for i in vm.history
                    if i.stop is not None) / 3600.0
        rate = self.rate(vm.demand)
        if vm.vm_type is VmType.SPOT:
            rate *= self.spot_discount
        return hours * rate

    def vm_od_equivalent(self, vm: Vm) -> float:
        hours = sum((i.stop - i.start) for i in vm.history
                    if i.stop is not None) / 3600.0
        return hours * self.rate(vm.demand)


def realized_cost_stats(vms: Iterable[Vm], engine, host_pool,
                        model: PriceModel | None = None) -> Dict[str, float]:
    """Cost accounting against the market engine's *realized* price series:
    spot VMs are billed each execution interval at their pool's clearing
    price (piecewise-constant between PRICE_TICKs), not a flat discount.

    ``engine`` is the :class:`repro.market.engine.MarketEngine` that ran the
    simulation (it holds the per-pool price integrals); ``host_pool`` maps
    each interval's host to its capacity pool.  The billed price is capped
    at the VM's bid — a spot VM riding out a spike above its bid (minimum
    running time, or an interruption-warning window) pays its bid, never
    the clearing price, honoring the bid contract.  On-demand VMs bill at
    the flat on-demand rate, exactly as in :func:`cost_stats`.

    The whole fleet's price integrals are computed in **one** batched
    :meth:`~repro.market.engine.MarketEngine.discount_integrals` call (one
    ``(pool, start, stop, bid-cap)`` row per closed execution interval);
    the remaining Python loop only accumulates the per-VM sums, in the same
    order as the historical per-VM walk.
    """
    model = model or PriceModel()
    tr = engine.tracer
    if tr.enabled:
        tr.begin("billing", "realized_cost")
    total = od_equiv = wasted = spot_cost = 0.0
    pool_of = host_pool.pool_of
    vm_list = list(vms)
    # gather every closed spot execution interval for one batched call
    pids: list = []
    t0s: list = []
    t1s: list = []
    caps: list = []
    for vm in vm_list:
        if vm.vm_type is not VmType.SPOT:
            continue
        for itv in vm.history:
            if itv.stop is None:
                continue
            pids.append(int(pool_of[itv.host]))
            t0s.append(itv.start)
            t1s.append(itv.stop)
            caps.append(vm.bid)
    discounts = engine.discount_integrals(
        np.asarray(pids, dtype=np.int64), np.asarray(t0s),
        np.asarray(t1s), np.asarray(caps))
    cursor = 0
    for vm in vm_list:
        rate = model.rate(vm.demand)
        od_c = model.vm_od_equivalent(vm)
        od_equiv += od_c
        if vm.vm_type is not VmType.SPOT:
            total += od_c
            continue
        c = 0.0
        for itv in vm.history:
            if itv.stop is None:
                continue
            c += rate / 3600.0 * float(discounts[cursor])
            cursor += 1
        total += c
        spot_cost += c
        if vm.state is VmState.TERMINATED:
            wasted += c
    if tr.enabled:
        # post-run call: stamp with the last tick time, not a live clock
        sim_t = float(engine.tick_times()[-1]) if engine.n_ticks else 0.0
        tr.end(sim_t, {"intervals": len(pids)})
    return {
        "cost": total,
        "od_equivalent": od_equiv,
        "savings": od_equiv - total,
        "savings_pct": 100.0 * (od_equiv - total) / max(od_equiv, 1e-12),
        "spot_cost": spot_cost,
        "wasted_cost": wasted,
    }


def cost_stats(vms: Iterable[Vm],
               model: PriceModel | None = None) -> Dict[str, float]:
    model = model or PriceModel()
    total = od_equiv = wasted = spot_cost = 0.0
    for vm in vms:
        c = model.vm_cost(vm)
        total += c
        od_equiv += model.vm_od_equivalent(vm)
        if vm.vm_type is VmType.SPOT:
            spot_cost += c
            if vm.state is VmState.TERMINATED:
                wasted += c     # paid for partial work, delivered nothing
    return {
        "cost": total,
        "od_equivalent": od_equiv,
        "savings": od_equiv - total,
        "savings_pct": 100.0 * (od_equiv - total) / max(od_equiv, 1e-12),
        "spot_cost": spot_cost,
        "wasted_cost": wasted,
    }
