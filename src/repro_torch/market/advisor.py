"""Synthetic AWS Spot-Instance-Advisor dataset (paper §VII-F).

The paper combines the Spot Advisor snapshot (interruption-frequency bands
<5 %, 5-10 %, 10-15 %, 15-20 %, >20 %), the spot price feed, and console
metadata into a 389-instance-type dataset, then measures which attributes
associate with interruption frequency (strongest: instance type 0.38, family
0.33, machine category 0.18).

Offline we generate a statistically similar dataset: interruption frequency is
drawn conditioned primarily on the exact *instance type* (strongest signal),
secondarily on *family*, weakly on *category* — so the correlation analysis
recovers the paper's ordering by construction, validating the pipeline.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

FREQ_BANDS = ["<5%", "5-10%", "10-15%", "15-20%", ">20%"]

_CATEGORIES = {
    "general": ["m5", "m5a", "m6i", "t3", "t3a"],
    "compute": ["c5", "c5a", "c6i", "c7g"],
    "memory": ["r5", "r5a", "r6i", "x2"],
    "accelerated": ["p3", "g4dn", "g5"],
    "storage": ["i3", "d3"],
}
_SIZES = ["large", "xlarge", "2xlarge", "4xlarge", "8xlarge"]
_REGIONS = ["us-east-1", "us-west-2", "eu-west-1"]
_OS = ["linux", "windows"]


def generate_advisor_dataset(n_rows: int = 1200, seed: int = 0) -> Dict[str, list]:
    """Columns: category, family, instance_type, region, os, vcpu, memory_gb,
    savings_pct, price_per_gb, gpu_count, day, free_tier, interruption_band."""
    rng = np.random.default_rng(seed)
    cats = list(_CATEGORIES.keys())

    # latent per-entity interruption propensities (the "ground truth" signal)
    fam_base: Dict[str, float] = {}
    type_base: Dict[str, float] = {}
    cat_base = {c: rng.uniform(0.3, 0.7) for c in cats}

    cols: Dict[str, list] = {k: [] for k in [
        "category", "family", "instance_type", "region", "os", "vcpu",
        "memory_gb", "savings_pct", "price_per_gb", "gpu_count", "day",
        "free_tier", "interruption_band"]}

    for _ in range(n_rows):
        cat = cats[rng.integers(len(cats))]
        fam = _CATEGORIES[cat][rng.integers(len(_CATEGORIES[cat]))]
        size = _SIZES[rng.integers(len(_SIZES))]
        itype = f"{fam}.{size}"
        if fam not in fam_base:
            fam_base[fam] = np.clip(cat_base[cat] + rng.normal(0, 0.22), 0, 1)
        if itype not in type_base:
            type_base[itype] = np.clip(fam_base[fam] + rng.normal(0, 0.3), 0, 1)

        vcpu = 2 ** (_SIZES.index(size) + 1)
        mem_mult = {"general": 4, "compute": 2, "memory": 8,
                    "accelerated": 4, "storage": 8}[cat]
        memory = vcpu * mem_mult
        gpu = int(rng.integers(1, 9)) if cat == "accelerated" else 0
        savings = float(np.clip(rng.normal(70, 12), 40, 90))
        price_gb = float(np.clip(rng.lognormal(-3.0, 0.4), 0.005, 0.5))

        # interruption propensity: dominated by exact type, plus band noise
        lam = 0.8 * type_base[itype] + 0.2 * rng.random()
        band = FREQ_BANDS[min(int(lam * len(FREQ_BANDS)), len(FREQ_BANDS) - 1)]

        cols["category"].append(cat)
        cols["family"].append(fam)
        cols["instance_type"].append(itype)
        cols["region"].append(_REGIONS[rng.integers(len(_REGIONS))])
        cols["os"].append(_OS[rng.integers(len(_OS))])
        cols["vcpu"].append(vcpu)
        cols["memory_gb"].append(memory)
        cols["savings_pct"].append(savings)
        cols["price_per_gb"].append(price_gb)
        cols["gpu_count"].append(gpu)
        cols["day"].append(int(rng.integers(7)))            # no signal (paper)
        cols["free_tier"].append(bool(rng.random() < 0.1))  # no signal (paper)
        cols["interruption_band"].append(band)

    for k in ("vcpu", "memory_gb", "savings_pct", "price_per_gb", "gpu_count",
              "day"):
        cols[k] = np.asarray(cols[k], dtype=np.float64)
    return cols


KINDS = {
    "category": "nominal", "family": "nominal", "instance_type": "nominal",
    "region": "nominal", "os": "nominal", "free_tier": "nominal",
    "interruption_band": "nominal",
    "vcpu": "numeric", "memory_gb": "numeric", "savings_pct": "numeric",
    "price_per_gb": "numeric", "gpu_count": "numeric", "day": "numeric",
}
