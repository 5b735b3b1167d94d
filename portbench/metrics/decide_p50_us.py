"""The median wall time of one placement decision over the window."""
import numpy as np


def read(rec):
    if not rec.decide_ns:
        return None
    return float(np.percentile(np.asarray(rec.decide_ns), 50)) / 1e3
