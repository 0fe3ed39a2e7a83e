"""k4_roofline: K4's (the EKF covariance step's) share of its roofline,
around the op entry ops/cov_update.py:cov_update (vio_bench/rooflines/
k4.py)."""
from ._roofline import share


def read(run):
    return share(run, "k4")
