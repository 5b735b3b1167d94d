"""Share of the traced window in which no operation ran on the device."""
from portbench.harness import busy_s


def read(rec):
    if not rec.device_events or rec.profiled_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(rec.device_events) / rec.profiled_s)
