"""Self time of the program tracer's ``allocation`` spans (``flush/*``:
the resubmission flush) as a share of the window's wall time.  The
placement decisions made inside a flush are ``policy`` spans of their own,
and not in it."""


def read(rec):
    s = rec.span_self.get("allocation")
    return None if s is None else 100.0 * s / rec.window_s
