"""setup_s: from the process's start to the first timed tick: imports,
the kernels' build where not built yet, the traffic's generation, the
program's set-up frames and the warm-up ticks."""


def read(run):
    return run.setup_s
