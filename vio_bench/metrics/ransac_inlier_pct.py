"""ransac_inlier_pct: RANSAC's inliers over the tracks entering it (the
ORB gate's survivors), in %, over the window (TrackerOutput's n_inliers
over n_orb_ok; the front end)."""
from ._counts import share


def read(run):
    return share(run, "n_inliers", "n_orb_ok")
