"""The comparisons that decide ``correct`` in the end-to-end cells: each
checked frame is computed by the plain reference (``reference/frontend.py``
and ``reference/larvio.py``) from the program's own state before it, and
held against what the program made of the same frame. Nothing here
imports the port.

- ``track_ids``: the largest share, over the checked rows and frames, of
  the tracker's rows that disagree: a row tracked on (its previous id
  kept) in one and not the other, or kept with another position than the
  other's within ``MATCH_PX``; the new detections, whose ids are ranks,
  are compared as the set of their (integer) pixel positions, each one
  without its twin in the other set a disagreement (the larger of the
  two sides' counts);
- ``track_px``: the largest gap in pixels between the two positions of a
  track both keep (inf where one side keeps tracks and none of them is
  kept by the other);
- ``filter_rel``: ``check.filter_rel`` of the filter state after the
  frame, with the in-state features' inverse depths as one more block
  (against the reference's largest); a differing feature table (ids, the
  in-state set, their slots or anchors) reads inf, as a differing clone
  window does;
- ``zupt_rel``: the same on the ZUPT frame kept from set-up;
- ``init_rel``: the state static initialization starts from (R, v, p, bg,
  ba, P) against the reference's own from the same IMU.

With control, the reference one precision step down stands in the
program's place: float16 for the float32 tracker, float32 for the float64
filter.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import check
from .reference import frontend as ref_fe
from .reference import larvio as ref_be

MATCH_PX = 0.5  # the largest gap between two positions of one kept track


def track_numbers(prog: dict, ref: dict, before: dict) -> tuple:
    """(rows that disagree, the largest gap of a track both keep): prog and
    ref the tracker state after the frame (xy, fid), before the state
    before it (fid, next_id)."""
    old = before["fid"] >= 0
    kept_p = old & (prog["fid"] == before["fid"])
    kept_r = old & (ref["fid"] == before["fid"])
    both = kept_p & kept_r
    gap = np.linalg.norm(prog["xy"] - ref["xy"], axis=1)
    # a side that keeps none of the tracks the other keeps is a gap
    # without bound
    px = (float(gap[both].max()) if both.any()
          else math.inf if (kept_p | kept_r).any() else 0.0)
    bad = int((kept_p != kept_r).sum()) + int((both & (gap > MATCH_PX)).sum())

    def new(s):
        rows = s["fid"] >= before["next_id"]
        return {tuple(np.round(xy).astype(int)) for xy in s["xy"][rows]}

    a, b = new(prog), new(ref)
    return bad + max(len(a - b), len(b - a)), px


def hybrid_rel(prog: dict, ref: dict) -> float:
    """check.filter_rel with the in-state features: a differing table
    reads inf."""
    same = all(np.array_equal(prog[k], ref[k]) for k in ("fid", "in_state"))
    ins = ref["in_state"]
    same = same and all(np.array_equal(prog[k][ins], ref[k][ins])
                        for k in ("state_slot", "anchor_slot"))
    if not same:
        return math.inf
    gap = check.filter_rel(prog, ref)
    if ins.any():
        a = np.asarray(prog["idp"], np.float64)[ins]
        b = np.asarray(ref["idp"], np.float64)[ins]
        gap = max(gap, float(np.abs(a - b).max())
                  / max(float(np.abs(b).max()), 1e-30))
    return gap if math.isfinite(gap) else math.inf


def _filter_frame(s: dict) -> dict:
    return {**s["imu"], **s["meas"]}


def numbers(cfg: dict, checked: dict, control: bool = False) -> dict:
    """The compared numbers of a run's checked frames."""
    tc, out = cfg["tracker"], {}
    low_t = torch.float16 if control else None
    low_f = np.float32 if control else None
    prep = {}

    def prepared(k, dtype):
        if (k, dtype) not in prep:
            prep[k, dtype] = ref_fe.prepare(tc, checked["images"][k], dtype)
        return prep[k, dtype]

    R_b2c = cfg["extrinsics"]["R_b2c"]
    for s in checked["samples"]:
        k = s["frame"]

        def tracker(dtype):
            return ref_fe.frame(tc, prepared(k - 1, dtype), prepared(k, dtype),
                                s["tracker_in"], s["t"], s["imu"], R_b2c,
                                s["gumbel"], k, dtype)

        want = tracker(torch.float64)
        got = tracker(low_t) if control else s["tracker_out"]
        bad, px = track_numbers(got, want, s["tracker_in"])
        n = len(want["fid"])
        check.worst(out, "track_ids", min(bad, n) / n)
        check.worst(out, "track_px", px)
        frame = _filter_frame(s)
        want = ref_be.step(cfg, s["filter_in"], frame)
        got = (ref_be.step(cfg, s["filter_in"], frame, low_f) if control
               else s["filter_out"])
        check.worst(out, "filter_rel", hybrid_rel(got, want))
    for s in checked["zupt"]:
        frame = _filter_frame(s)
        want = ref_be.step(cfg, s["filter_in"], frame)
        got = (ref_be.step(cfg, s["filter_in"], frame, low_f) if control
               else s["filter_out"])
        check.worst(out, "zupt_rel", hybrid_rel(got, want))
    st = checked["start"]
    want = ref_be.static_init(cfg, st["imu"])
    got = ref_be.static_init(cfg, st["imu"], low_f) if control else \
        {k: st["program"][k] for k in want}
    none = {"cvalid": np.zeros(0, bool), "corder": np.zeros(0, np.int64),
            "cR": np.zeros((0, 3, 3)), "cp": np.zeros((0, 3))}
    check.worst(out, "init_rel", check.filter_rel({**got, **none},
                                                  {**want, **none}))
    return out
