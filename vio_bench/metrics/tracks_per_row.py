"""tracks_per_row: the valid tracks after the tracker (RANSAC's inliers
plus the detections placed, TrackerOutput's counts), averaged over rows
and the window's ticks (the front end)."""
from ._counts import per_row_tick


def read(run):
    return per_row_tick(run, "n_inliers", "n_placed")
