"""k1_roofline: K1's (the window gather's) share of its roofline, around the op
entry frontend/klt.py:gather_windows (vio_bench/rooflines/k1.py)."""
from ._roofline import share


def read(run):
    return share(run, "k1")
