"""Roofline terms of a dry-run cell under H100 constants.

A port of the reference package's ``launch/hlo_stats.py``.  The reference
also parses optimized HLO text there: ``collective_bytes`` sums the operand
sizes of every collective instruction and ``while_trip_counts`` reads the
loop trip counts.  A torch step has no HLO; ``hlo_analyzer.analyze``
counts the collectives that DTensor issues as the step runs, by kind and
with their operand bytes, and the dry-run counts the layer loop by tracing
depth 1 and 2 (see ``dryrun.run_cell``), so neither function has a
counterpart here.

The roofline seconds are a model, not a measurement: the least time the
counted work could take on ``chips`` cards at these peak rates.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU data sheet, dense rates
# without sparsity, at the full 700 W power limit):
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
# Collective link: the 16-wide "model" axis of the production meshes spans
# two 8-GPU nodes, so its traffic crosses the inter-node fabric: one
# 400 Gb/s NDR InfiniBand port per GPU = 50 GB/s.  Inside a node each GPU
# has NVLink 4 at 900 GB/s both ways, 450 GB/s in one direction.
LINK_BW = 50e9               # bytes/s per card, inter-node (NDR 400 Gb/s)
NVLINK_BW = 450e9            # bytes/s per card and direction, intra-node


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> dict:
    compute_s = flops / (chips * PEAK_FLOPS) if flops else 0.0
    memory_s = hbm_bytes / (chips * HBM_BW) if hbm_bytes else 0.0
    collective_s = coll_bytes / (chips * LINK_BW) if coll_bytes else 0.0
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = max(bound, 1e-30)
    terms.update({
        "dominant": dominant,
        "bound_s": bound,
        "roofline_fraction_compute": compute_s / total,
    })
    return terms
