"""StarMap keypoint detector: a raw image and 2D bboxes to semantic
keypoints.

Counterpart of ``orcvio_tpu/objects/detector.py`` (reference: the StarMap
nodelet, starmap.cpp:606-696). For each tracked bbox: a square crop around
it, the resize to the network's input, the network and its peaks, labels
by joint geometry against projected view templates of the canonical car
(with a temporal prior along each box's track), then the keypoints back
through the crop into the image and undistorted to NORMALIZED camera
coordinates for ``ObjectVio.step``. The bboxes themselves are an external
input, as the reference's darknet boxes are.

The network runs on `device` (the card unless given), one crop at a
time as in the JAX package; the label assignment is numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import no_tf32, resolve_device
from ..dataio.render_object import look_at, render_car
from ..frontend.undistort import undistort_pixels
from ..models.starmap import detect_keypoints, load_pretrained


def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along
    one axis, float64: a triangle kernel at the output pixels' centres,
    widened by n_in / n_out when it downsamples (antialiasing), each
    column renormalized over the input's pixels
    (jax/_src/image/scale.py:_compute_weight_mat)."""
    inv = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


class StarMapKeypointDetector:
    """The network on `device` and the host's label assignment.

    K_cam = (fx, fy, cx, cy); canonical (K, 3) the class's mean keypoints
    (config object_keypoints_mean). Crops are resized to the network's
    input size; the peaks map back through the crop transform and are
    undistorted to normalized coordinates.
    """

    def __init__(self, canonical, K_cam, path=None,
                 dist_model: str = "radtan", dist_coeffs=(0.0, 0.0, 0.0, 0.0),
                 dtype=torch.float32, geometric_labels: bool = True,
                 yaw_bins: int = 36, device=None):
        self.device = resolve_device(device)
        no_tf32()
        self.dtype = dtype
        self.model, meta = load_pretrained(path, self.device, dtype)
        self.size = int(meta["input_size"])
        self.K_cam = K_cam
        self.dist_model = dist_model
        self.dist_coeffs = tuple(dist_coeffs)
        self.n_kps = int(np.asarray(canonical).shape[0])
        self.canonical_np = np.asarray(canonical, np.float64)
        self.canon = torch.as_tensor(self.canonical_np, dtype=dtype,
                                     device=self.device)
        self.geometric_labels = geometric_labels
        self.yaw_bins = yaw_bins
        self._proj_templates = (
            self._build_yaw_templates(yaw_bins) if geometric_labels else None)
        # per-box temporal memory: (bbox, winning template index) of the
        # previous frame, matched by IoU: the per-frame template match is
        # mirror-ambiguous with few peaks, while the true yaw moves less
        # than a bin a frame, so the prior keeps the labels consistent
        # along a track, as triangulation needs
        self._prev_boxes: np.ndarray = np.zeros((0, 4))
        self._prev_tmpl: np.ndarray = np.zeros((0,), np.int64)
        self._weights: dict = {}  # resize weights by (n_in, n_out)

    def _build_yaw_templates(self, yaw_bins: int, elevations=(0.1, 0.35),
                             dist_factor: float = 3.0):
        """Bbox-normalized 2D projections of the canonical keypoints over a
        (yaw x elevation) grid of views: ((V, K, 2) templates in [0, 1]^2,
        (V, K) visibility, (V,) yaw bin).

        The cvf head of a small hourglass cannot tell the left/right
        symmetric car keypoints apart; labels by joint geometry can:
        project the canonical structure at each view, normalize it to its
        2D bbox, and match the (bbox-normalized) peaks to it; the best
        view's matching gives the labels, the cvf distance only breaks the
        mirror ties.
        """
        kps = self.canonical_np
        d = dist_factor * float(np.max(np.linalg.norm(kps, axis=1)))
        S = 96
        f = S * d / 6.0
        Kc = (f, f, S / 2, S / 2)
        rng = np.random.default_rng(0)
        temps, vises, yaws = [], [], []
        ctr = kps.mean(axis=0)
        for el in elevations:
            for yi, g in enumerate(np.linspace(0, 2 * np.pi, yaw_bins,
                                               endpoint=False)):
                cam = ctr + np.array([d * np.cos(el) * np.cos(g),
                                      d * np.cos(el) * np.sin(g),
                                      d * np.sin(el)])
                r = render_car(look_at(cam, ctr), cam, Kc, S, rng=rng)
                vis = r.kp_visible
                if vis.sum() < 3:
                    continue
                uv = r.kp_uv.astype(np.float64)
                lo = uv[vis].min(axis=0)
                span = np.maximum(uv[vis].max(axis=0) - lo, 1e-6)
                temps.append((uv - lo) / span)
                vises.append(vis)
                yaws.append(yi)
        return np.asarray(temps), np.asarray(vises), np.asarray(yaws)

    def _assign_geometric(self, peaks_xy, peaks_valid, peaks_cvf, peaks_score,
                          bbox_hm, prior_tmpl: int = -1):
        """Joint labels: the best (yaw, elevation) template by greedy 2D
        matching in bbox-normalized coordinates, the cvf breaking ties.

        peaks_xy (P, 2) heatmap pixels; bbox_hm (4,) the DETECTION's bbox
        in heatmap pixels (peaks and templates both normalize to the whole
        car's extent). Returns (best_idx (K,), found (K,), template) or
        None.
        """
        K = self.n_kps
        # absolute and relative score gate: real keypoints cluster near
        # the strongest peak, hallucinated ones trail far below it
        smax = float(np.max(np.where(peaks_valid, peaks_score, 0.0)))
        v = peaks_valid & (peaks_score > max(0.45, 0.55 * smax))
        if v.sum() < 3:
            return None  # too few peaks for joint geometry
        lo = np.asarray(bbox_hm[:2])
        span = np.maximum(np.asarray(bbox_hm[2:]) - lo, 1e-6)
        pn = (peaks_xy - lo) / span  # (P, 2)
        cvf_d = np.linalg.norm(
            peaks_cvf[:, None, :] - self.canonical_np[None, :, :], axis=-1)
        cvf_cost = 0.12 * cvf_d / max(1.0, np.max(np.linalg.norm(
            self.canonical_np, axis=1)))
        best = (None, np.inf, -1)
        templates, t_vis, t_yaw = self._proj_templates
        nb = self.yaw_bins
        if prior_tmpl >= 0:
            dy = np.abs(t_yaw - t_yaw[prior_tmpl])
            yaw_pen = 0.012 * np.minimum(dy, nb - dy).astype(np.float64)
        else:
            yaw_pen = np.zeros(len(templates))
        for ti, (tmpl, tv) in enumerate(zip(templates, t_vis)):
            d2 = np.linalg.norm(pn[:, None, :] - tmpl[None, :, :], axis=-1)
            cost = d2 + cvf_cost
            cost[~v] = np.inf
            cost[:, ~tv] = np.inf  # occluded at this view: unmatched
            # greedy one-to-one matching, cheapest pair first
            c = cost.copy()
            assign = np.full(K, -1, np.int64)
            total, matched = 0.0, 0
            for _ in range(min(int(v.sum()), K)):
                i = np.argmin(c)
                pi, ki = divmod(i, K)
                if not np.isfinite(c[pi, ki]) or d2[pi, ki] > 0.35:
                    break
                assign[ki] = pi
                total += cost[pi, ki]
                matched += 1
                c[pi, :] = np.inf
                c[:, ki] = np.inf
            if matched < 3:
                continue
            score = total / matched - 0.08 * matched + yaw_pen[ti]
            if score < best[1]:
                best = (assign, score, ti)
        if best[0] is None:
            return None
        assign = best[0]
        found = assign >= 0
        return np.where(found, assign, 0), found, best[2]

    def resize(self, patch):
        """``jax.image.resize(patch, (size, size), "linear")`` of an (h, w)
        tensor: two products with the axes' weights; an axis already of
        the size is left as it is, as JAX leaves it."""
        out = patch
        for axis, n in enumerate(patch.shape):
            if n == self.size:
                continue
            key = (n, self.size)
            if key not in self._weights:
                self._weights[key] = torch.as_tensor(
                    linear_resize_weights(n, self.size), dtype=patch.dtype,
                    device=patch.device)
            w = self._weights[key]
            out = w.T @ out if axis == 0 else out @ w
        return out

    def crop(self, img, box):
        """The network's input for one pixel bbox of `img` (H, W) in [0,
        1]: the (size, size) resized square crop on the device, and its
        integer bounds (x0, x1, y0, y1) in the image. The square has a
        margin around the bbox centre (1.5 x its longer side), so the
        aspect ratio is the one the network was trained on (square renders
        with the object spanning some half of the crop)."""
        H, W = img.shape
        x0, y0, x1, y1 = box
        cx_b = 0.5 * (x0 + x1)
        cy_b = 0.5 * (y0 + y1)
        half = 0.75 * max(x1 - x0, y1 - y0)
        x0i = int(np.clip(cx_b - half, 0, W - 2))
        x1i = int(np.clip(cx_b + half, x0i + 2, W))
        y0i = int(np.clip(cy_b - half, 0, H - 2))
        y1i = int(np.clip(cy_b + half, y0i + 2, H))
        patch = torch.as_tensor(img[y0i:y1i, x0i:x1i]).to(self.device,
                                                          self.dtype)
        return self.resize(patch), (x0i, x1i, y0i, y1i)

    def __call__(self, img, boxes_px, valid):
        """img (H, W) float in [0, 255] or [0, 1]; boxes_px (M, 4) pixel
        bboxes. Returns (kps_norm (M, K, 2) float32, kps_mask (M, K)) in
        normalized (undistorted) camera coordinates."""
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        M = len(boxes_px)
        kps = np.zeros((M, self.n_kps, 2), np.float32)
        mask = np.zeros((M, self.n_kps), bool)
        new_boxes: list = []
        new_tmpl: list = []
        for m in range(M):
            if not bool(valid[m]):
                continue
            x0, y0, x1, y1 = boxes_px[m]
            crop, (x0i, x1i, y0i, y1i) = self.crop(img, boxes_px[m])
            det = detect_keypoints(self.model,
                                   crop.expand(1, 3, self.size, self.size),
                                   self.canon)
            det = {k: det[k][0].cpu().numpy() for k in (
                "found", "kp_xy", "peaks_xy", "peaks_valid", "peaks_cvf",
                "peaks_score")}
            found = det["found"]
            uv_heat = det["kp_xy"]  # heatmap pixels (size/4 grid)
            if self.geometric_labels:
                sx_ = (x1i - x0i) / self.size
                sy_ = (y1i - y0i) / self.size
                bbox_hm = np.array([(x0 - x0i) / sx_ / 4.0,
                                    (y0 - y0i) / sy_ / 4.0,
                                    (x1 - x0i) / sx_ / 4.0,
                                    (y1 - y0i) / sy_ / 4.0])
                prior = -1
                if len(self._prev_boxes):
                    iou = _bbox_iou_np(np.asarray([x0, y0, x1, y1],
                                                  np.float64),
                                       self._prev_boxes)
                    j = int(np.argmax(iou))
                    if iou[j] > 0.3:
                        prior = int(self._prev_tmpl[j])
                res = self._assign_geometric(
                    det["peaks_xy"].astype(np.float64), det["peaks_valid"],
                    det["peaks_cvf"].astype(np.float64),
                    det["peaks_score"].astype(np.float64), bbox_hm,
                    prior_tmpl=prior)
                if res is not None:
                    assign, found, tmpl_i = res
                    uv_heat = det["peaks_xy"].astype(np.float64)[assign]
                    new_boxes.append([x0, y0, x1, y1])
                    new_tmpl.append(tmpl_i)
            # heatmap -> crop -> image pixels
            sx = (x1i - x0i) / self.size
            sy = (y1i - y0i) / self.size
            uv_img = np.stack([uv_heat[:, 0] * 4.0 * sx + x0i,
                               uv_heat[:, 1] * 4.0 * sy + y0i], axis=1)
            kps[m] = undistort_pixels(
                torch.as_tensor(uv_img, dtype=torch.float32), self.K_cam,
                self.dist_model, self.dist_coeffs).numpy()
            mask[m] = found
        self._prev_boxes = np.asarray(new_boxes, np.float64).reshape(-1, 4)
        self._prev_tmpl = np.asarray(new_tmpl, np.int64)
        return kps, mask


def _bbox_iou_np(box, boxes):
    """IoU of one box (4,) against (N, 4), xmin ymin xmax ymax."""
    ix0 = np.maximum(box[0], boxes[:, 0])
    iy0 = np.maximum(box[1], boxes[:, 1])
    ix1 = np.minimum(box[2], boxes[:, 2])
    iy1 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    a = np.maximum(box[2] - box[0], 0) * np.maximum(box[3] - box[1], 0)
    b = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(
        boxes[:, 3] - boxes[:, 1], 0)
    return inter / np.maximum(a + b - inter, 1e-9)
