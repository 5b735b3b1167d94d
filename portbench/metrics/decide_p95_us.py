"""The 95th percentile of the wall time of one placement decision, over
every decision of the window (numpy's linear interpolation)."""
import numpy as np


def read(rec):
    if not rec.decide_ns:
        return None
    return float(np.percentile(np.asarray(rec.decide_ns), 95)) / 1e3
