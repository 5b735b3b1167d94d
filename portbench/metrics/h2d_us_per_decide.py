"""Device time of host-to-device copies per placement decision, from the
profiler's device trace of the window."""


def read(rec):
    if not rec.device_events or not rec.decide_ns:
        return None
    t = sum(t1 - t0 for name, t0, t1 in rec.device_events
            if "HtoD" in name)
    return t / len(rec.decide_ns) if t > 0 else None
