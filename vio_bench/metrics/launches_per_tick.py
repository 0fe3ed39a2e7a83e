"""launches_per_tick: device kernels in the CUDA-only trace of the
traced ticks, per tick (the batched step's launches)."""


def read(run):
    t = run.trace
    return t["kernels"] / t["ticks"] if t and t["kernels"] else None
