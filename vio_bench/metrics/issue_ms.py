"""issue_ms: host milliseconds inside each tick's call of the entry,
with no synchronisation, averaged over the window's ticks: the host's
cost of issuing a tick (the many-stream replay layer)."""


def read(run):
    return 1e3 * run.issue_s / run.ticks if run.ticks else None
