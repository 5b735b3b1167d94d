"""Self time of the ``policy`` spans (the harness opens one around each
placement decision, inside the program's tracer) as a share of the window's
wall time: the allocation policy's share, taken out of the spans around it."""


def read(rec):
    s = rec.span_self.get("policy")
    return None if s is None else 100.0 * s / rec.window_s
