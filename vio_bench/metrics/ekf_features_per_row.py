"""ekf_features_per_row: the 1-d inverse-depth features living in the
state after each frame (FrameOutput.n_ekf_features), averaged over rows
and the window's ticks: the hybrid filter's load (the filter layer)."""
from ._counts import per_row_tick


def read(run):
    return per_row_tick(run, "n_ekf")
