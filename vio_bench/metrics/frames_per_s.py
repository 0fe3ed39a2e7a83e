"""frames_per_s: every row's frames completed in the window, over the
window's seconds (the host clock, from the first call to the
synchronisation after the last)."""


def read(run):
    return run.ticks * run.rows / run.window_s
