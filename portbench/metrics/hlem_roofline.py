"""The HLEM scoring kernel's share of its roofline: the least time of every
call in the traced window over the kernel's device time there.  Each
call's least time comes from its shapes (``portbench/roofline.py``); the
kernel's device time from the profiler's trace.  Nothing is read when the
calls seen at the kernel entry and the kernels in the trace do not pair."""
from portbench.roofline import hlem_least_s

KERNEL = "hlem_score_kernel"


def read(rec):
    if not rec.device_events or not rec.kernel_calls:
        return None
    times = [t1 - t0 for name, t0, t1 in rec.device_events if KERNEL in name]
    if len(times) != len(rec.kernel_calls) or not times:
        return None
    least = sum(hlem_least_s(n, d, b)[0] for n, d, b in rec.kernel_calls)
    return 100.0 * least / (sum(times) * 1e-6)
