"""lk_ok_pct: the tracks surviving Lucas-Kanade and its forward-backward
gate over the tracks entering it, in %, over the window (TrackerOutput's
n_lk_ok over n_lk_in; the front end)."""
from ._counts import share


def read(run):
    return share(run, "n_lk_ok", "n_lk_in")
