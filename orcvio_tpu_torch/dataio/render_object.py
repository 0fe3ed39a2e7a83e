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
(``eval/object_map_cnn.py``) use it. The training batches
(``make_training_batch``) are not part of the port.
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
