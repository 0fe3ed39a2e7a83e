"""What the kernels' roofline readers share."""


def share(run, name):
    """A kernel's share of its roofline, in %: the least time the chip
    could take for the work its op entry was called for (vio_bench/
    rooflines/<name>.py's count at vio_bench/peaks.py's rates), over the
    device time of every kernel launched inside the entry's calls. None
    where the traced ticks made no such call."""
    k = run.kernels.get(name)
    if not k or k["device_s"] <= 0 or k["least_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["device_s"]
