"""Self time of the program tracer's ``market-tick`` (tick phases),
``market-engine`` (price processes) and ``migration`` (planner) spans as
a share of the window's wall time."""

CATEGORIES = ("market-tick", "market-engine", "migration")


def read(rec):
    found = [rec.span_self[c] for c in CATEGORIES if c in rec.span_self]
    return 100.0 * sum(found) / rec.window_s if found else None
