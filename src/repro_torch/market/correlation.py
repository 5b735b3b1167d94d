"""Mixed-type association measures (paper §VII-F).

The paper uses the ``dython.nominal`` library: Theil's U for nominal-nominal
pairs, the correlation ratio (eta) for numeric-categorical, and Pearson for
numeric-numeric.  Re-implemented here in numpy (no external deps).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np


def _entropy(labels: Sequence) -> float:
    n = len(labels)
    if n == 0:
        return 0.0
    counts = Counter(labels)
    return -sum((c / n) * math.log(c / n) for c in counts.values())


def conditional_entropy(x: Sequence, y: Sequence) -> float:
    """H(X|Y)."""
    n = len(x)
    if n == 0:
        return 0.0
    y_counts = Counter(y)
    xy_counts = Counter(zip(x, y))
    h = 0.0
    for (xv, yv), c_xy in xy_counts.items():
        p_xy = c_xy / n
        p_y = y_counts[yv] / n
        h -= p_xy * math.log(p_xy / p_y)
    return h


def theils_u(x: Sequence, y: Sequence) -> float:
    """Theil's uncertainty coefficient U(X|Y) in [0, 1] (asymmetric)."""
    h_x = _entropy(x)
    if h_x == 0.0:
        return 1.0
    return (h_x - conditional_entropy(x, y)) / h_x


def correlation_ratio(categories: Sequence, values: np.ndarray) -> float:
    """eta: numeric-categorical association in [0, 1]."""
    values = np.asarray(values, dtype=np.float64)
    cats: Dict = {}
    for c, v in zip(categories, values):
        cats.setdefault(c, []).append(v)
    mean_all = values.mean()
    ss_between = sum(len(v) * (np.mean(v) - mean_all) ** 2 for v in cats.values())
    ss_total = ((values - mean_all) ** 2).sum()
    if ss_total <= 0:
        return 0.0
    return float(np.sqrt(ss_between / ss_total))


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    sx, sy = x.std(), y.std()
    if sx <= 0 or sy <= 0:
        return 0.0
    return float(((x - x.mean()) * (y - y.mean())).mean() / (sx * sy))


def association_matrix(
    columns: Dict[str, Sequence],
    kinds: Dict[str, str],   # name -> 'nominal' | 'numeric'
) -> Dict[str, Dict[str, float]]:
    """Pairwise association with dython-style measure selection.

    nominal-nominal  -> Theil's U (row given column),
    numeric-nominal  -> correlation ratio,
    numeric-numeric  -> |Pearson|.
    """
    names = list(columns.keys())
    out: Dict[str, Dict[str, float]] = {n: {} for n in names}
    for a in names:
        for b in names:
            if a == b:
                out[a][b] = 1.0
                continue
            ka, kb = kinds[a], kinds[b]
            if ka == "nominal" and kb == "nominal":
                v = theils_u(columns[a], columns[b])
            elif ka == "nominal" and kb == "numeric":
                v = correlation_ratio(columns[a], columns[b])
            elif ka == "numeric" and kb == "nominal":
                v = correlation_ratio(columns[b], columns[a])
            else:
                v = abs(pearson(columns[a], columns[b]))
            out[a][b] = float(v)
    return out
