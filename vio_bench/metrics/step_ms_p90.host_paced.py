"""step_ms_p90.host_paced: the 90th percentile, over every tick of the
window, of the milliseconds between consecutive tick-end CUDA events
(recorded after each tick's call, with no host read): the control tick
the rows served together see. Per-layer, with no bound: the host paces
the tick, and host times spread too widely between runs to hold it."""
import math


def read(run):
    xs = sorted(run.step_ms)
    if not xs:
        return None
    return xs[min(len(xs) - 1, max(0, math.ceil(0.9 * len(xs)) - 1))]
