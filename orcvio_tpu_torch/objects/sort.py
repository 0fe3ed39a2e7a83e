"""SORT multi-object 2D box tracking with a batched auction assignment.

Counterpart of ``orcvio_tpu/objects/sort.py`` (reference:
``ros_wrapper/src/sort_ros/src/sort_tracking.cpp``: IoU cost, Hungarian
assignment ``Hungarian.cpp``, a KF per box and the track lifecycle with
max_age / min_hits / lost flags). The Hungarian solver is the JAX
package's fixed-iteration auction (Bertsekas), run for the same 200
rounds with the same results: the bids' scatter-max and the winners'
scatter-min are ``scatter_reduce("amax" / "amin")``, and ties go to the
lowest row. Track slots are a fixed-capacity table with masks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..filter.state import set_rows
from ..tree import Tree
from .kf import Kf7State, kf7_init, kf7_predict, kf7_update, z_to_bbox


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU: (N, 4) x (M, 4) -> (N, M); boxes xmin, ymin, xmax,
    ymax."""
    ax1, ay1, ax2, ay2 = (boxes_a[:, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (boxes_b[None, :, i] for i in range(4))
    iw = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                     min=0.0)
    inter = iw * ih
    area_a = torch.clamp((ax2 - ax1) * (ay2 - ay1), min=0.0)
    area_b = torch.clamp((bx2 - bx1) * (by2 - by1), min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def auction_assign(benefit, valid_rows, valid_cols, iters: int = 200,
                   eps: float = 1e-3):
    """Maximize the summed benefit (N, M) with an auction in which the rows
    (trackers) bid for the columns (detections). Returns row_to_col (N,)
    int32, -1 where unassigned; invalid rows and columns never assign. A
    fixed count of rounds, as the JAX package's ``lax.scan``; for IoU
    benefits in [0, 1] and eps = 1e-3 it is effectively optimal."""
    N, M = benefit.shape
    dev = benefit.device
    neg = -1e9
    b = torch.where(valid_rows[:, None] & valid_cols[None, :], benefit, neg)
    rows = torch.arange(N, device=dev, dtype=torch.int32)
    prices = torch.zeros(M, dtype=b.dtype, device=dev)
    owner = torch.full((M,), -1, dtype=torch.int32, device=dev)
    no_bid = torch.full((M,), -torch.inf, dtype=b.dtype, device=dev)
    no_row = torch.full((M,), N, dtype=torch.int32, device=dev)
    unowned = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    for _ in range(iters):
        assigned = unowned.index_fill(
            0, torch.where(owner >= 0, owner, N).long(), True)[:N]
        need = valid_rows & ~assigned
        value = b - prices[None, :]
        best_col = torch.argmax(value, dim=1)
        best_val = torch.gather(value, 1, best_col[:, None])[:, 0]
        second_val = torch.amax(value.scatter(1, best_col[:, None], neg),
                                dim=1)
        bid = best_val - second_val + eps
        # among the rows bidding for one column the highest bid wins (a
        # scatter-max over the columns), the lowest row of equal bids
        bid_eff = torch.where(need & (best_val > neg / 2), bid, -torch.inf)
        col_bid = no_bid.scatter_reduce(0, best_col, bid_eff, "amax")
        winner = (bid_eff == col_bid[best_col]) & need
        win_row = no_row.scatter_reduce(
            0, best_col, torch.where(winner, rows, N), "amin")
        col_updated = win_row < N
        prices = torch.where(col_updated,
                             prices + torch.clamp(col_bid, min=0.0), prices)
        owner = torch.where(col_updated, win_row, owner)
    row_to_col = set_rows(
        torch.full((N,), -1, dtype=torch.int32, device=dev),
        torch.where(owner >= 0, owner, N),
        torch.arange(M, dtype=torch.int32, device=dev))
    # drop assignments whose benefit is the invalid sentinel
    bval = torch.gather(b, 1, torch.clamp(row_to_col, 0, M - 1).long()[:, None])
    return torch.where((row_to_col >= 0) & (bval[:, 0] > neg / 2),
                       row_to_col, -1)


class SortConfig(NamedTuple):
    capacity: int = 16  # tracks at once
    max_age: int = 2  # frames without a match before a track dies
    min_hits: int = 3  # matches before a track is reported
    iou_threshold: float = 0.3
    max_track_frames: int = 10**9  # max_object_feature_track_length


@dataclasses.dataclass
class SortState(Tree):
    kf: Kf7State  # batched (C,)
    track_id: torch.Tensor  # (C,) int32, -1 free
    class_id: torch.Tensor  # (C,) int32
    hits: torch.Tensor  # (C,) int32
    age: torch.Tensor  # (C,) frames since the last match
    frames: torch.Tensor  # (C,) frames tracked
    next_id: torch.Tensor  # () int32

    @classmethod
    def create(cls, sc: SortConfig, dtype=torch.float32, device=None):
        C = sc.capacity

        def i32(v, shape=(C,)):
            return torch.full(shape, v, dtype=torch.int32, device=device)

        return cls(
            kf=Kf7State(x=torch.zeros((C, 7), dtype=dtype, device=device),
                        P=torch.eye(7, dtype=dtype, device=device).repeat(
                            C, 1, 1)),
            track_id=i32(-1), class_id=i32(-1), hits=i32(0), age=i32(0),
            frames=i32(0), next_id=i32(0, ()))


class SortOutput(NamedTuple):
    bboxes: torch.Tensor  # (C, 4) the tracks' boxes
    track_id: torch.Tensor  # (C,)
    class_id: torch.Tensor  # (C,)
    reported: torch.Tensor  # (C,) bool: confirmed (hits >= min_hits)
    lost: torch.Tensor  # (C,) bool: died this frame (lost_flag)
    lost_id: torch.Tensor  # (C,) int32: id of the track that died, else -1


def sort_step(sc: SortConfig, s: SortState, det_boxes, det_class, det_valid):
    """One SORT frame. Ref: sort_tracking.cpp:62-225. det_boxes (M, 4),
    det_class (M,), det_valid (M,)."""
    C = s.track_id.shape[0]
    M = det_boxes.shape[0]
    dev = det_boxes.device
    live = s.track_id >= 0
    kf_pred = kf7_predict(s.kf)
    iou = iou_matrix(z_to_bbox(kf_pred.x[..., :4]), det_boxes)
    # match only detections of the track's class
    same_class = ((s.class_id[:, None] == det_class[None, :])
                  | (s.class_id[:, None] < 0))
    benefit = torch.where(same_class, iou, 0.0)
    row_to_col = auction_assign(benefit, live, det_valid)
    det_idx = torch.clamp(row_to_col, 0, M - 1).long()
    matched_iou = torch.gather(benefit, 1, det_idx[:, None])[:, 0]
    matched = (row_to_col >= 0) & (matched_iou >= sc.iou_threshold) & live
    kf_new = kf7_update(kf_pred, det_boxes[det_idx], matched)

    hits = torch.where(matched, s.hits + 1, s.hits)
    age = torch.where(matched, 0, s.age + 1).to(torch.int32)
    frames = torch.where(live, s.frames + 1, 0).to(torch.int32)
    died = live & ((age > sc.max_age) | (frames >= sc.max_track_frames))
    track_id = torch.where(died, -1, s.track_id).to(torch.int32)

    # new tracks for the unmatched detections, in free slots by rank
    det_taken = set_rows(torch.zeros(M, dtype=torch.bool, device=dev),
                         torch.where(matched, row_to_col, M),
                         torch.ones(C, dtype=torch.bool, device=dev))
    det_new = det_valid & ~det_taken
    free = track_id < 0
    free_rank = torch.cumsum(free, 0) - 1
    new_rank = torch.cumsum(det_new, 0) - 1
    can = det_new & (new_rank < free.sum())
    rank_to_slot = set_rows(
        torch.zeros(C, dtype=torch.int64, device=dev),
        torch.where(free, free_rank, C), torch.arange(C, device=dev))
    slots = torch.where(can, rank_to_slot[torch.clamp(new_rank, 0, C - 1)], C)

    init_kf = kf7_init(det_boxes)
    kf_x = set_rows(kf_new.x, slots, init_kf.x)
    kf_P = set_rows(kf_new.P, slots, init_kf.P)
    n_new = torch.cumsum(can, 0).to(torch.int32)
    track_id = set_rows(track_id, slots, s.next_id + n_new - 1)
    class_id = set_rows(s.class_id, slots, det_class.to(torch.int32))
    ones = torch.ones(M, dtype=torch.int32, device=dev)
    hits = set_rows(hits, slots, ones)
    age = set_rows(age, slots, 0 * ones)
    frames = set_rows(frames, slots, ones)

    out = SortOutput(
        bboxes=z_to_bbox(kf_x[..., :4]), track_id=track_id,
        class_id=class_id, reported=(track_id >= 0) & (hits >= sc.min_hits),
        lost=died, lost_id=torch.where(died, s.track_id, -1).to(torch.int32))
    return s.replace(kf=Kf7State(x=kf_x, P=kf_P), track_id=track_id,
                     class_id=class_id, hits=hits, age=age, frames=frames,
                     next_id=s.next_id + can.sum().to(torch.int32)), out
