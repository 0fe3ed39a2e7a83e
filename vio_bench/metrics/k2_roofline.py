"""k2_roofline: K2's (Lucas-Kanade over a level's) share of its roofline, around
the op entry frontend/klt.py:lk_level_src (vio_bench/rooflines/k2.py)."""
from ._roofline import share


def read(run):
    return share(run, "k2")
