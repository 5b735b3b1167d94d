"""Peaks of the card and the least time of the program's kernels.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit.  A kernel's least time is the larger of its operations over the
peak rate and its bytes over the memory rate, each input byte read once
and each output byte written once, whatever the kernel reads again.
"""
from __future__ import annotations

from typing import Optional, Tuple

HBM_BYTES_PER_S = 3.35e12     # device memory
F64_OPS_PER_S = 34e12         # float64 outside the tensor cores


def hlem_bytes(n: int, d: int, b: int) -> int:
    """One HLEM scoring call (paper Eqs. 3-11) of ``b`` rows over ``n``
    hosts with ``d`` resource dimensions: float64 free capacity and spot
    fraction (n, d) read, a mask byte per row and host and a float64 alpha
    per row read, a float64 score per row and host written."""
    return 2 * n * d * 8 + b * n + b * 8 + b * n * 8


def hlem_ops(d: int, candidates: int) -> int:
    """Float64 operations of the same call: 29*d + 2 per candidate host and
    row (compares, subtracts, divides, logs, multiplies and adds over the
    four stages, the two compensated dot products at 8 a term)."""
    return (29 * d + 2) * candidates


def hlem_least_s(n: int, d: int, b: int,
                 candidates: Optional[int] = None) -> Tuple[float, str]:
    """(least seconds, "bytes" | "operations") of one call.  Without
    ``candidates`` every host of every row counts as one, the most the
    operations can be: where bytes bound even then, as at every fleet size
    of these cells, the least time does not depend on the masks."""
    t_bytes = hlem_bytes(n, d, b) / HBM_BYTES_PER_S
    t_ops = hlem_ops(d, n * b if candidates is None else candidates) \
        / F64_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
