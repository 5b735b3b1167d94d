"""Self time of the program tracer's ``event-loop`` spans (one per event
dispatch) as a share of the window's wall time.  The placement decisions
made inside a dispatch are ``policy`` spans of their own, and not in it."""


def read(rec):
    s = rec.span_self.get("event-loop")
    return None if s is None else 100.0 * s / rec.window_s
