"""Simulated seconds completed per wall second: all replays' simulated time
over all of the window's wall time (the paper's unit of simulator speed)."""


def read(rec):
    return rec.sim_s / rec.window_s if rec.window_s > 0 else None
