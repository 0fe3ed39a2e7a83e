"""device_idle_pct: 100 minus the share of the traced ticks' span (the
host clock, between two synchronisations) that the union of the device's
activity intervals covers."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
