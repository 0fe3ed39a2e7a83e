"""The parametric car: its 12 semantic keypoints and a software renderer.

Counterpart of ``orcvio_tpu/dataio/render_object.py``'s renderer half
(the reference's keypoint model, config/object_feat_kitti.yaml
object_keypoints_mean: 4 roof corners, front and rear lights, 4 wheels;
metres, z up, y forward). Two Lambertian boxes (body and cabin), four
wheel discs and four light patches, rasterized with a per-pixel depth
buffer; the keypoints are labelled visible by a depth test. Pure numpy
on the host, so its images are bit for bit the JAX package's. The
synthetic object world, the detector's view templates
(``objects/detector.py``) and config B's composite frames
(``eval/object_map_cnn.py``) use it, and so do the training batches
(``make_training_batch``) that ``scripts/train_starmap.py`` trains the
StarMap network on. Their blur augment resizes as ``cv2.resize`` does,
with two numpy functions of this module in its place: ``area_resize``
(``INTER_AREA``, downscaling) and ``linear_resize`` (``INTER_LINEAR``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

CAR_KEYPOINTS = np.array([
    [-0.568, -0.253, 1.331], [0.568, -0.253, 1.331],   # roof rear L/R
    [0.482, 1.570, 1.331], [-0.482, 1.570, 1.331],     # roof front R/L
    [-0.582, -1.988, 0.702], [0.582, -1.988, 0.702],   # rear lights L/R
    [0.702, 1.961, 0.924], [-0.702, 1.961, 0.924],     # head lights R/L
    [-0.805, -1.286, 0.329], [-0.805, 1.355, 0.329],   # wheels L rear/front
    [0.805, -1.286, 0.329], [0.805, 1.355, 0.329],     # wheels R rear/front
])
WHEEL_RADIUS = 0.329
N_KEYPOINTS = 12


def _box_faces(xm, xp, ym, yp, zm, zp):
    """Quad faces of an axis-aligned box (outward CCW winding)."""
    c = lambda x, y, z: np.array([x, y, z], float)
    return [
        [c(xm, ym, zm), c(xm, yp, zm), c(xm, yp, zp), c(xm, ym, zp)],  # -x
        [c(xp, ym, zm), c(xp, ym, zp), c(xp, yp, zp), c(xp, yp, zm)],  # +x
        [c(xm, ym, zm), c(xm, ym, zp), c(xp, ym, zp), c(xp, ym, zm)],  # -y
        [c(xm, yp, zm), c(xp, yp, zm), c(xp, yp, zp), c(xm, yp, zp)],  # +y
        [c(xm, ym, zp), c(xm, yp, zp), c(xp, yp, zp), c(xp, ym, zp)],  # +z
        [c(xm, ym, zm), c(xp, ym, zm), c(xp, yp, zm), c(xm, yp, zm)],  # -z
    ]


def car_faces():
    """Quads of the parametric car (body + cabin), object frame.

    Dimensions chosen so the canonical keypoints sit ON visible surfaces:
    the cabin top matches the roof-corner footprint exactly, the body is
    narrower than the wheel track (discs protrude), and its floor is above
    the wheel centers.
    """
    body = _box_faces(-0.78, 0.78, -2.0, 2.0, 0.42, 0.95)
    cabin = _box_faces(-0.568, 0.568, -0.253, 1.570, 0.95, 1.331)
    return body + cabin


def light_patches():
    """Small bright quads on the body end faces at the light keypoints."""
    quads = []
    for k in (4, 5):  # rear lights, face y = -2.0
        x, _, z = CAR_KEYPOINTS[k]
        y = -2.004
        quads.append([np.array([x - 0.11, y, z - 0.09]),
                      np.array([x + 0.11, y, z - 0.09]),
                      np.array([x + 0.11, y, z + 0.09]),
                      np.array([x - 0.11, y, z + 0.09])])
    for k in (6, 7):  # head lights, face y = +2.0
        x, _, z = CAR_KEYPOINTS[k]
        y = 2.004
        quads.append([np.array([x - 0.11, y, z - 0.09]),
                      np.array([x + 0.11, y, z - 0.09]),
                      np.array([x + 0.11, y, z + 0.09]),
                      np.array([x - 0.11, y, z + 0.09])])
    return quads


def wheel_discs():
    """(center (3,), normal axis sign) for the four wheel discs (x planes)."""
    return [(CAR_KEYPOINTS[i], -1.0 if CAR_KEYPOINTS[i][0] < 0 else 1.0)
            for i in (8, 9, 10, 11)]


class Render(NamedTuple):
    image: np.ndarray  # (H, W) float32 in [0, 1]
    kp_uv: np.ndarray  # (12, 2) pixel coords in the crop
    kp_visible: np.ndarray  # (12,) bool (depth-tested)
    kp_depth: np.ndarray  # (12,) camera-frame depth (m)


def look_at(cam_pos, target, up=(0.0, 0.0, 1.0)):
    """R_w2c, with camera +z forward, +x right, +y down."""
    f = np.asarray(target, float) - np.asarray(cam_pos, float)
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, float))
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    return np.stack([r, d, f])


def render_car(R_w2c, cam_pos, K, size: int, albedo=0.55, light=None,
               background=None, rng=None):
    """Rasterize the car with a depth buffer; label the 12 keypoints.

    K = (fx, fy, cx, cy) for the size x size crop. Object frame == world
    frame (callers move the camera, or pre-transform via wTo).
    """
    H = W = size
    fx, fy, cx, cy = K
    rng = rng or np.random.default_rng(0)
    if light is None:
        light = np.array([0.4, -0.3, 0.85])
    light = light / np.linalg.norm(light)

    img = (background if background is not None
           else np.full((H, W), 0.35, np.float32)).astype(np.float32).copy()
    depth = np.full((H, W), np.inf, np.float32)
    xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)

    def project(pts):
        pc = (R_w2c @ (pts - cam_pos).T).T  # (N, 3)
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], axis=1)
        return uv, pc[:, 2]

    def inside_convex(uv):
        """Winding-agnostic convex-polygon test: all edge functions same sign."""
        pos = np.ones((H, W), bool)
        neg = np.ones((H, W), bool)
        n_v = len(uv)
        for i in range(n_v):
            a, b = uv[i], uv[(i + 1) % n_v]
            e = (xs - a[0]) * (b[1] - a[1]) - (ys - a[1]) * (b[0] - a[0])
            pos &= e >= 0
            neg &= e <= 0
        return pos | neg

    def fill_quad(quad, shade, emissive=False):
        quad = np.asarray(quad)
        n = np.cross(quad[1] - quad[0], quad[3] - quad[0])
        nn = n / np.linalg.norm(n)
        # orient outward (away from the car's interior)
        if nn @ (quad.mean(0) - np.array([0.0, 0.0, 0.7])) < 0:
            nn = -nn
        if nn @ (cam_pos - quad[0]) <= 0:  # back-face
            return
        uv, z = project(quad)
        if np.any(z <= 0.05):
            return
        lum = shade if emissive else \
            shade * (0.35 + 0.65 * max(0.0, float(nn @ light)))
        inside = inside_convex(uv)
        if not inside.any():
            return
        # plane depth per pixel: z from plane equation in camera frame
        pc0 = R_w2c @ (quad[0] - cam_pos)
        nc = R_w2c @ nn
        # ray r(t) = t * dir, dir = ((x-cx)/fx, (y-cy)/fy, 1); t = n.pc0 / n.dir
        dirx = (xs - cx) / fx
        diry = (ys - cy) / fy
        denom = nc[0] * dirx + nc[1] * diry + nc[2]
        t = (nc @ pc0) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        upd = inside & (t > 0) & (t < depth)
        img[upd] = lum
        depth[upd] = t[upd]

    def fill_disc(center, axis_sign, radius, shade):
        nn = np.array([axis_sign, 0.0, 0.0])
        if nn @ (cam_pos - center) <= 0:
            return
        # sample the disc as a polygon (16-gon) in its plane
        ang = np.linspace(0, 2 * np.pi, 17)[:-1]
        ring = center[None, :] + radius * np.stack(
            [np.zeros_like(ang), np.cos(ang), np.sin(ang)], axis=1)
        uv, z = project(ring)
        if np.any(z <= 0.05):
            return
        inside = inside_convex(uv)
        if not inside.any():
            return
        pc0 = R_w2c @ (center - cam_pos)
        nc = R_w2c @ nn
        dirx = (xs - cx) / fx
        diry = (ys - cy) / fy
        denom = nc[0] * dirx + nc[1] * diry + nc[2]
        t = (nc @ pc0) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        upd = inside & (t > 0) & (t <= depth + 1e-3)
        img[upd] = shade
        depth[upd] = np.minimum(depth[upd], t[upd])

    for quad in car_faces():
        fill_quad(quad, albedo)
    for quad in light_patches():
        fill_quad(quad, 0.95, emissive=True)
    for center, sgn in wheel_discs():
        fill_disc(center, sgn, WHEEL_RADIUS, 0.08)  # dark tires
        fill_disc(center, sgn, WHEEL_RADIUS * 0.4, 0.75)  # bright hub

    kp_uv, kp_z = project(CAR_KEYPOINTS)
    ui = np.clip(np.round(kp_uv[:, 0]).astype(int), 0, W - 1)
    vi = np.clip(np.round(kp_uv[:, 1]).astype(int), 0, H - 1)
    in_img = (kp_uv[:, 0] >= 1) & (kp_uv[:, 0] < W - 1) & \
             (kp_uv[:, 1] >= 1) & (kp_uv[:, 1] < H - 1)
    visible = in_img & (kp_z > 0) & (kp_z <= depth[vi, ui] + 0.12)
    img += rng.normal(0.0, 0.01, img.shape).astype(np.float32)
    return Render(np.clip(img, 0.0, 1.0), kp_uv.astype(np.float32),
                  visible, kp_z.astype(np.float32))


def random_view(rng, size: int = 96, dist_range=(4.5, 9.0),
                elev_range=(0.08, 0.6)):
    """Random camera pose looking near the car center + matching intrinsics."""
    az = rng.uniform(0, 2 * np.pi)
    el = rng.uniform(*elev_range)
    d = rng.uniform(*dist_range)
    cam = np.array([d * np.cos(el) * np.cos(az),
                    d * np.cos(el) * np.sin(az),
                    0.7 + d * np.sin(el)])
    target = np.array([0.0, 0.0, 0.7]) + rng.normal(0, 0.15, 3)
    R_w2c = look_at(cam, target)
    # car span 0.45-0.8 of the crop: the deployment crop puts the bbox at
    # 1/1.5 of the square (detector margin 0.75 * max extent)
    f = size * d / rng.uniform(4.2, 7.5)
    K = (f, f, size / 2 + rng.normal(0, 2), size / 2 + rng.normal(0, 2))
    return R_w2c, cam, K


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) float32 weights of cv2's INTER_AREA downscale along
    one axis (imgproc/resize.cpp: computeResizeAreaTab): each output cell
    averages the source interval [d scale, (d + 1) scale), a partial
    pixel at either end by its covered share, over the cell's width."""
    scale = 1.0 / (n_dst / n_src)
    w = np.zeros((n_dst, n_src), np.float32)
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(int(np.floor(f2)), n_src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = np.float32((s1 - f1) / cell)
        w[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def area_resize(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA) of a
    square float32 image (H, H), size < H: each output pixel the
    area-weighted mean of the source pixels its cell covers, the ratio
    not an integer. Sums in float32, rows of the source first."""
    w = _area_weights(img.shape[0], size)
    rows = np.einsum("ij,yj->yi", w, img.astype(np.float32))
    return np.einsum("ij,jx->ix", w, rows).astype(np.float32)


def _linear_taps(n_src: int, n_dst: int):
    """(left index, right index, right weight) of cv2's INTER_LINEAR along
    one axis of an image of more than one row and column: source
    coordinate (d + 0.5) scale - 0.5 in float64, its fraction rounded to
    float32 (the left weight is 1 - that, in float32), indices clamped at
    the borders (a weight of 0 past either edge)."""
    scale = 1.0 / (n_dst / n_src)
    fx = (np.arange(n_dst) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    fx[(sx < 0) | (sx >= n_src - 1)] = 0.0
    sx = np.clip(sx, 0, n_src - 1)
    return sx, np.minimum(sx + 1, n_src - 1), fx


def linear_resize(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR) of a
    square float32 image: bilinear, the rows first, then the columns, in
    float32."""
    lo, hi, f = _linear_taps(img.shape[0], size)
    img = img.astype(np.float32)
    one = np.float32(1.0)
    rows = img[:, lo] * (one - f) + img[:, hi] * f
    return (rows[lo] * (one - f)[:, None] + rows[hi] * f[:, None]).astype(
        np.float32)


def make_training_batch(rng, batch: int, size: int = 96, heat_sigma=1.0,
                        clutter: bool = True, blur_augment: bool = True):
    """(images (B, S, S, 3), targets (B, S/4, S/4, 5), masks (B, S/4, S/4,
    1)), NHWC float32, drawn from the numpy Generator `rng` in the JAX
    package's order, so one seed gives the same scenes.

    Target channels: [heat, cvf_x, cvf_y, cvf_z, depth_norm]; cvf and
    depth are supervised only where mask > 0 (the keypoint neighbourhoods);
    depth is relative to the camera's distance to the car's centre.
    ``clutter`` paints distractor quads and (a third of the time) a second
    car, unlabeled, under the target; ``blur_augment`` (60 %) downscales
    to s in [30, S) with ``area_resize`` and back with ``linear_resize``,
    then adds noise: the deployment crops of far cars, upscaled.
    """
    S = size
    Hh = S // 4
    imgs = np.empty((batch, S, S), np.float32)
    heats = np.zeros((batch, Hh, Hh), np.float32)
    cvf = np.zeros((batch, Hh, Hh, 3), np.float32)
    dep = np.zeros((batch, Hh, Hh), np.float32)
    mask = np.zeros((batch, Hh, Hh), np.float32)
    yy, xx = np.meshgrid(np.arange(Hh), np.arange(Hh), indexing="ij")

    for b in range(batch):
        R_w2c, cam, K = random_view(rng, S)
        bg = rng.uniform(0.15, 0.75) + rng.normal(0, 0.05, (S, S))
        bg = bg.astype(np.float32)
        if clutter:
            for _ in range(rng.integers(0, 4)):
                w = rng.integers(4, S // 2)
                h = rng.integers(4, S // 2)
                x = rng.integers(0, S - 4)
                y = rng.integers(0, S - 4)
                bg[y:y + h, x:x + w] = np.clip(
                    bg[y:y + h, x:x + w] + rng.uniform(-0.35, 0.35), 0, 1)
            if rng.uniform() < 0.35:
                R2, cam2, _ = random_view(rng, S)
                cam2 = cam2 + rng.normal(0, 2.0, 3)
                r2 = render_car(R2, cam2, K, S, albedo=rng.uniform(0.35, 0.85),
                                background=bg, rng=rng)
                bg = np.asarray(r2.image)
        r = render_car(R_w2c, cam, K, S,
                       albedo=rng.uniform(0.35, 0.85),
                       light=rng.normal(0, 1, 3) + np.array([0, 0, 1.5]),
                       background=bg, rng=rng)
        im = np.asarray(r.image)
        if blur_augment and rng.uniform() < 0.6:
            s = int(rng.integers(30, S))
            im = linear_resize(area_resize(im, s), S)
            im = np.clip(im + rng.normal(0, rng.uniform(0.005, 0.03),
                                         im.shape), 0, 1).astype(np.float32)
        imgs[b] = im
        d0 = np.linalg.norm(cam - np.array([0.0, 0.0, 0.7]))
        for k in range(N_KEYPOINTS):
            if not r.kp_visible[k]:
                continue
            u, v = r.kp_uv[k] / 4.0
            g = np.exp(-((xx - u) ** 2 + (yy - v) ** 2) / (2 * heat_sigma**2))
            heats[b] = np.maximum(heats[b], g)
            sel = g > 0.2
            cvf[b][sel] = CAR_KEYPOINTS[k]
            dep[b][sel] = r.kp_depth[k] / d0
            mask[b] = np.maximum(mask[b], sel.astype(np.float32))

    images = np.repeat(imgs[..., None], 3, axis=-1)
    targets = np.concatenate(
        [heats[..., None], cvf, dep[..., None]], axis=-1)
    return images, targets, mask[..., None]
