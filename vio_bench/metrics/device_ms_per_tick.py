"""device_ms_per_tick: the union of the device's activity intervals
(kernels, copies, sets) over the traced ticks, per tick."""


def read(run):
    t = run.trace
    return 1e3 * t["busy_s"] / t["ticks"] if t and t["busy_s"] > 0 else None
