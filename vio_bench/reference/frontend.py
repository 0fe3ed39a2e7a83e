"""The plain reference of the end-to-end cells' front end: one camera frame
of the tracker in plain torch on the CPU, written from the algorithms its
stages document, one stage after another, with no kernel, cache, batching
or vmap. It imports nothing of the port.

The stages and what each is written from:

- histogram equalization (the port's global stand-in for the upstream's
  cv::CLAHE, createImagePyramids, image_processor.cpp:322);
- the pyramid: a 5-tap binomial blur (1 4 6 4 1)/16 with replicated edges,
  every other row and column kept (cv::pyrDown's kernel);
- pyramidal Lucas-Kanade (cv::calcOpticalFlowPyrLK, image_processor.cpp:568)
  with the gyro-aided prediction R_b2c exp(-w dt) R_b2c^T on normalized
  coordinates, inverse-compositional Gauss-Newton steps on a bilinear
  template and its central-difference gradients, stopped per feature once
  a step is under 0.01 px (the upstream's track_precision, cv::TermCriteria
  EPS) or after klt_iters steps; then the reverse pass at level 0 and the
  1 px forward-backward gate (image_processor.cpp:628-652);
- Shi-Tomasi corners: the structure tensor's smaller eigenvalue,
  tr / 2 - sqrt(tr^2 / 4 - det), over a 3x3 box of central-difference
  gradient products, 3x3 non-maximum suppression, a square zone of
  2 min_distance + 1 px around each tracked feature, 1 % of the best
  score, and each grid cell's best per_cell (the masked
  goodFeaturesToTrack, image_processor.cpp:341,1015-1047);
- ORB's rotated BRIEF (Rublee et al. 2011; the intensity-centroid angle
  over a radius-15 disc, 256 point-pair tests rotated by it) gated at a
  Hamming distance of 58 (image_processor.cpp:463,707);
- RANSAC on the fundamental matrix (cv::findFundamentalMat's gate,
  image_processor.cpp:508,743-767): eight-point hypotheses scored by their
  squared Sampson distance in normalized coordinates, the best count's
  inliers kept;
- radial-tangential undistortion by fixed-point iteration
  (image_processor.cpp:1050-1084).

Where the port departs from the upstream on purpose, this computes the
port's documented semantics from its definition:

- equalization is ``equalize_hist``'s "poly" mode: a 64-bin histogram of
  every 4th pixel's gray level (rounded to the nearest bin), its CDF fit by
  a degree-8 least-squares polynomial on 64 equispaced knots in [0, 1]
  whose operator is stored in float32, applied by Horner's rule to every
  pixel and clipped to [0, 255];
- a feature's search window is 36 px around floor(prediction) clamped into
  the level, and its iterates are clamped to the window's interior;
  convergence also asks for a Hessian determinant over 1e-6, a last step
  under 1 px and a final position 1e-3 px inside the window, a level-0
  residual (mean |I - T|) under 25 and a position 2 px inside the image;
  the reverse pass searches from the forward start's own window;
- images are read with replicated edges, every bilinear tap included;
- there is no first-frame special case: a frame with nothing tracked is
  tracked as any other;
- the ORB test pattern is a seeded Gaussian one (numpy's default_rng(42),
  sigma 7.5 px, clipped to 15 px, stored in float32), not ORB's learned
  table, and the patch is sampled bilinearly at the keypoint's subpixel
  position;
- RANSAC draws its 128 eight-point samples by Gumbel-max: the draws are
  given (the program's own), each sample's index the argmax of its noise
  over the candidates; each hypothesis's F is the null vector of the
  design matrix A from 3 inverse-iteration solves of (A^T A + 1e-7 tr I)
  from a vector of ones, with no rank-2 projection; with fewer than 12
  candidates every candidate is kept;
- re-detection runs on every detect_every-th frame only; detections are
  ranked by score (ties in candidate order) and placed, strongest first,
  in the free rows in row order, each with the next id.

``dtype`` sets the precision every float is computed in: float64 is the
reference, float16 the control one step below the program's float32 (its
linear solves run in float32 and are rounded back to float16, since the
CPU has no float16 solver).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SEARCH = 36  # search-window span, px
KLT_EPS = 0.01  # track_precision
FB_GATE = 1.0  # forward-backward gate, px
MAX_RESIDUAL = 25.0
HYPOTHESES = 128
BINS, DEGREE, SUBSAMPLE = 64, 8, 4
BORDER, QUALITY = 8, 0.01
ORB_RADIUS, ORB_BITS = 15, 256

_FLAGS = {"equalize": True, "dist_model": "radtan"}


def check_flags(tc: dict) -> None:
    """Raise where the tracker configuration asks for a path this
    reference does not compute."""
    wrong = {k: tc.get(k) for k, v in _FLAGS.items() if tc.get(k) != v}
    if tc.get("detect_every", 1) < 1:
        wrong["detect_every"] = tc.get("detect_every")
    if wrong:
        raise ValueError(f"the front-end reference covers {_FLAGS}; "
                         f"got {wrong}")


# --- images ---

def _px(img, x, y):
    """img at integer (x, y) tensors, edges replicated."""
    H, W = img.shape
    return img[y.clamp(0, H - 1), x.clamp(0, W - 1)]


def bilinear(img, x, y):
    """img at subpixel (x, y) (same shapes), edges replicated."""
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi, yi = x0.long(), y0.long()
    top = _px(img, xi, yi) * (1 - fx) + _px(img, xi + 1, yi) * fx
    bot = _px(img, xi, yi + 1) * (1 - fx) + _px(img, xi + 1, yi + 1) * fx
    return top * (1 - fy) + bot * fy


@functools.lru_cache(maxsize=4)
def _poly_operator():
    """(DEGREE + 1, BINS) least-squares fit operator, stored in float32."""
    x = np.linspace(0.0, 1.0, BINS)
    V = np.stack([x ** d for d in range(DEGREE + 1)], axis=1)
    return np.linalg.solve(V.T @ V, V.T).astype(np.float32)


def equalize(img, dt):
    """The poly-mode global equalization of a [0, 255] image."""
    img = img.clamp(0, 255)
    sub = img[::SUBSAMPLE, ::SUBSAMPLE]
    idx = torch.clamp(sub / 255.0 * (BINS - 1), 0, BINS - 1).round().long()
    hist = torch.bincount(idx.reshape(-1), minlength=BINS).to(dt)
    cdf = torch.cumsum(hist, 0) / hist.sum()
    coef = torch.as_tensor(_poly_operator()).to(dt) @ cdf
    xn = img / 255.0
    out = torch.full_like(img, float(coef[DEGREE]))
    for d in range(DEGREE - 1, -1, -1):
        out = out * xn + coef[d]
    return torch.clamp(out, 0.0, 1.0) * 255.0


def pyramid(img, levels: int):
    """[level 0, ...]: blur (1 4 6 4 1)/16 with replicated edges, every
    other row and column."""
    w = [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16]
    out = [img]
    for _ in range(levels - 1):
        a = out[-1]
        H, W = a.shape
        ys = torch.arange(0, H, 2)
        xs = torch.arange(0, W, 2)
        rows = sum(w[i] * a[(ys + i - 2).clamp(0, H - 1)] for i in range(5))
        out.append(sum(w[i] * rows[:, (xs + i - 2).clamp(0, W - 1)]
                       for i in range(5)))
    return out


def gradients(img):
    """Central differences with replicated edges: (Ix, Iy)."""
    H, W = img.shape
    x, y = torch.arange(W), torch.arange(H)
    Ix = 0.5 * img[:, (x + 1).clamp(max=W - 1)] - 0.5 * img[:, (x - 1).clamp(min=0)]
    Iy = 0.5 * img[(y + 1).clamp(max=H - 1)] - 0.5 * img[(y - 1).clamp(min=0)]
    return Ix, Iy


# --- Lucas-Kanade ---

def _patch(img, x0, y0, n: int):
    """(N, n, n) bilinear patches whose (0, 0) tap is at (x0, y0)."""
    a = torch.arange(n, dtype=img.dtype)
    return bilinear(img, x0[:, None, None] + a[None, None, :],
                    y0[:, None, None] + a[None, :, None])


def _window(p, shape, r: int):
    """(lo, hi) (N, 2) of a patch centre in the search window around
    floor(p), clamped into the level of `shape` (H, W)."""
    H, W = shape
    f = torch.floor(p)
    start = torch.stack([f[:, 0].clamp(0, W - 1), f[:, 1].clamp(0, H - 1)],
                        1) - SEARCH // 2
    lo = start + r
    return lo, lo + (SEARCH - 2 * r - 1.001)


def lk(img0, img1, p0, p_init, bounds, P: int, iters: int):
    """Lucas-Kanade of the template of img0 at p0 over img1 from p_init,
    iterates clamped to bounds (lo, hi). Returns (p, converged, mean
    |I - T| at p)."""
    r = (P - 1) // 2
    lo, hi = bounds
    tp = _patch(img0, p0[:, 0] - (r + 1), p0[:, 1] - (r + 1), P + 2)
    t = tp[:, 1:-1, 1:-1]
    gx = 0.5 * (tp[:, 1:-1, 2:] - tp[:, 1:-1, :-2])
    gy = 0.5 * (tp[:, 2:, 1:-1] - tp[:, :-2, 1:-1])
    a11, a12, a22 = ((u * v).sum((1, 2)) for u, v in ((gx, gx), (gx, gy),
                                                       (gy, gy)))
    det = a11 * a22 - a12 * a12
    det_s = torch.where(det > 1e-6, det, torch.ones_like(det))
    p = torch.minimum(torch.maximum(p_init, lo), hi)
    step = torch.full_like(det, float("inf"))
    for _ in range(iters):
        on = step > KLT_EPS
        err = _patch(img1, p[:, 0] - r, p[:, 1] - r, P) - t
        b1, b2 = (gx * err).sum((1, 2)), (gy * err).sum((1, 2))
        d = torch.stack([(a22 * b1 - a12 * b2) / det_s,
                         (a11 * b2 - a12 * b1) / det_s], 1)
        p = torch.where(on[:, None],
                        torch.minimum(torch.maximum(p - d, lo), hi), p)
        step = torch.where(on, torch.linalg.norm(d, dim=1), step)
    res = (_patch(img1, p[:, 0] - r, p[:, 1] - r, P) - t).abs().mean((1, 2))
    inside = ((p > lo + 1e-3) & (p < hi - 1e-3)).all(1)
    return p, (det > 1e-6) & (step < 1.0) & inside, res


def track(pyr0, pyr1, xy0, guess, P: int, iters: int):
    """Coarse-to-fine LK, then the reverse pass at level 0 and the
    forward-backward gate: (positions, ok)."""
    L = len(pyr0)
    r = (P - 1) // 2
    p1 = guess / 2.0 ** (L - 1)
    for lv in range(L - 1, -1, -1):
        if lv != L - 1:
            p1 = p1 * 2.0
        p0 = xy0 / 2.0 ** lv
        bounds1 = _window(p1, pyr1[lv].shape, r)
        p1, conv, res = lk(pyr0[lv], pyr1[lv], p0, p1, bounds1, P, iters)
    H, W = pyr0[0].shape
    inb = ((p1[:, 0] > 2) & (p1[:, 0] < W - 3) & (p1[:, 1] > 2)
           & (p1[:, 1] < H - 3))
    ok = conv & inb & (res < MAX_RESIDUAL)
    q, conv_b, _ = lk(pyr1[0], pyr0[0], p1, xy0, _window(xy0, (H, W), r), P,
                      iters)
    fb = torch.linalg.norm(q - xy0, dim=1)
    return p1, ok & conv_b & (fb < FB_GATE)


# --- detection ---

def _max3(x, k: int, dim: int):
    """Max over a centred window of k along dim, -inf beyond the edges."""
    n = x.shape[dim]
    pad = torch.full_like(x.narrow(dim, 0, 1), float("-inf"))
    xs = torch.cat([pad.expand_as(x.narrow(dim, 0, k // 2))
                    if k // 2 else x.narrow(dim, 0, 0), x,
                    pad.expand_as(x.narrow(dim, 0, k // 2))
                    if k // 2 else x.narrow(dim, 0, 0)], dim)
    return torch.stack([xs.narrow(dim, i, n) for i in range(k)]).amax(0)


def shi_tomasi(img):
    Ix, Iy = gradients(img)

    def box(a):
        H, W = a.shape
        y, x = torch.arange(H), torch.arange(W)
        rows = sum(a[(y + i).clamp(0, H - 1)] for i in (-1, 0, 1)) / 3.0
        return sum(rows[:, (x + i).clamp(0, W - 1)] for i in (-1, 0, 1)) / 3.0

    Sxx, Syy, Sxy = box(Ix * Ix), box(Iy * Iy), box(Ix * Iy)
    tr, det = Sxx + Syy, Sxx * Syy - Sxy * Sxy
    return tr / 2 - torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))


def detect(tc: dict, img, score_nms, occupied_xy):
    """Each grid cell's best per_cell corners away from the tracked
    features: (xy (C * n, 2), score, valid), cell by cell."""
    H, W = img.shape
    score = score_nms.clone()
    zone = torch.zeros((H, W), dtype=torch.bool)
    if len(occupied_xy):
        ix = occupied_xy[:, 0].to(torch.int64).clamp(0, W - 1)
        iy = occupied_xy[:, 1].to(torch.int64).clamp(0, H - 1)
        m = int(tc["min_distance"])
        for x, y in zip(ix.tolist(), iy.tolist()):
            zone[max(y - m, 0): y + m + 1, max(x - m, 0): x + m + 1] = True
    score = torch.where(zone, torch.zeros_like(score), score)
    score = torch.where(score > QUALITY * score.max(), score,
                        torch.zeros_like(score))
    R, C, n = tc["grid_rows"], tc["grid_cols"], tc["per_cell"]
    ch, cw = H // R, W // C
    xy, sc = [], []
    for i in range(R):
        for j in range(C):
            cell = score[i * ch:(i + 1) * ch, j * cw:(j + 1) * cw].reshape(-1)
            _, k = torch.topk(cell, n)
            sc.append(cell[k])
            xy.append(torch.stack([j * cw + k % cw, i * ch + k // cw], 1))
    sc = torch.cat(sc)
    return torch.cat(xy).to(img.dtype), sc, sc > 0


def score_map(img):
    """Shi-Tomasi scores after 3x3 non-maximum suppression and the border."""
    s = shi_tomasi(img)
    H, W = s.shape
    m = _max3(_max3(s, 3, 0), 3, 1)
    s = torch.where(s >= m, s, torch.zeros_like(s))
    y, x = torch.arange(H)[:, None], torch.arange(W)[None, :]
    inb = (y >= BORDER) & (y < H - BORDER) & (x >= BORDER) & (x < W - BORDER)
    return torch.where(inb, s, torch.zeros_like(s))


# --- ORB ---

@functools.lru_cache(maxsize=1)
def _pattern():
    pts = np.random.default_rng(42).normal(0.0, ORB_RADIUS / 2.0,
                                           size=(ORB_BITS, 4))
    return np.clip(pts, -ORB_RADIUS, ORB_RADIUS).astype(np.float32)


def describe(img, xy):
    """(N, 256) bool tests of each keypoint's rotated pattern."""
    R = ORB_RADIUS + 1
    a = torch.arange(-R, R + 1, dtype=img.dtype)
    oy, ox = torch.meshgrid(a, a, indexing="ij")
    patch = _patch(img, xy[:, 0] - R, xy[:, 1] - R, 2 * R + 1)
    disc = (ox * ox + oy * oy <= ORB_RADIUS ** 2).to(img.dtype)
    ang = torch.atan2((patch * oy * disc).sum((1, 2)),
                      (patch * ox * disc).sum((1, 2)))
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    pat = torch.as_tensor(_pattern()).to(img.dtype)

    def sample(q):  # pattern points (256, 2) about each keypoint
        u = c * q[None, :, 0] - s * q[None, :, 1]
        v = s * q[None, :, 0] + c * q[None, :, 1]
        u = torch.clamp(u + R, 0.0, 2 * R - 0.001)
        v = torch.clamp(v + R, 0.0, 2 * R - 0.001)
        iu, iv = torch.floor(u), torch.floor(v)
        fu, fv = u - iu, v - iv
        n = torch.arange(len(xy))[:, None]
        iu, iv = iu.long(), iv.long()
        left = patch[n, iv, iu] * (1 - fv) + patch[n, iv + 1, iu] * fv
        right = patch[n, iv, iu + 1] * (1 - fv) + patch[n, iv + 1, iu + 1] * fv
        return left * (1 - fu) + right * fu

    return sample(pat[:, 0:2]) < sample(pat[:, 2:4])


def words(bits):
    """(N, 256) bits as (N, 8) 32-bit words, bit i of word w test 32 w + i."""
    w = torch.tensor([1 << i for i in range(32)], dtype=torch.int64)
    return (bits.reshape(-1, 8, 32).to(torch.int64) * w).sum(-1)


def hamming(d1, d2):
    x = np.bitwise_xor(np.asarray(d1, np.int64), np.asarray(d2, np.int64))
    return np.array([sum(bin(int(v)).count("1") for v in row) for row in x])


# --- RANSAC ---

def _solve(M, b):
    """M^-1 b, in float32 where M is float16 (no float16 solver)."""
    if M.dtype == torch.float16:
        return torch.linalg.solve(M.float(), b.float()).half()
    return torch.linalg.solve(M, b)


def ransac(p1, p2, valid, gumbel, thresh: float):
    """Inliers of the best eight-point hypothesis, the draws given."""
    if int(valid.sum()) < 12:
        return valid
    dt = p1.dtype
    noise = gumbel + torch.where(valid, 0.0, float("-inf")).to(gumbel.dtype)
    idx = noise.argmax(-1)  # (HYP, 8)
    x1, y1 = p1[idx, 0], p1[idx, 1]
    x2, y2 = p2[idx, 0], p2[idx, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)
    AtA = A.transpose(1, 2) @ A
    M = AtA + 1e-7 * torch.diagonal(AtA, dim1=1, dim2=2).sum(-1)[:, None,
                                                                  None] \
        * torch.eye(9, dtype=dt)
    v = torch.ones((len(A), 9, 1), dtype=dt)
    for _ in range(3):
        v = _solve(M, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                            min=1e-30)
    F = v.reshape(-1, 3, 3)
    h1 = torch.cat([p1, torch.ones_like(p1[:, :1])], 1)
    h2 = torch.cat([p2, torch.ones_like(p2[:, :1])], 1)
    Fx1 = torch.einsum("hij,nj->hni", F, h1)
    Ftx2 = torch.einsum("hji,nj->hni", F, h2)
    e = torch.einsum("ni,hni->hn", h2, Fx1)
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    d = e * e / torch.clamp(den, min=1e-12)
    inl = (d < thresh) & valid[None]
    return inl[int(inl.sum(1).argmax())]


# --- the frame ---

def prepare(tc: dict, image_u8, dtype=torch.float64):
    """What a frame shares over every row: the equalized image's pyramid
    and, on a detection frame, its suppressed score map."""
    img = equalize(torch.as_tensor(np.asarray(image_u8)).to(dtype), dtype)
    pyr = pyramid(img, tc["pyramid_levels"])
    return {"pyr": pyr, "score": score_map(img)}


def undistort(tc: dict, xy):
    """Pixels to ideal normalized coordinates (radtan, 8 fixed-point
    steps)."""
    fx, fy, cx, cy = tc["K"]
    k1, k2, q1, q2 = tc["dist_coeffs"]
    x0, y0 = (xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy
    x, y = x0, y0
    for _ in range(8):
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        x = (x0 - (2 * q1 * x * y + q2 * (r2 + 2 * x * x))) / rad
        y = (y0 - (q1 * (r2 + 2 * y * y) + 2 * q2 * x * y)) / rad
    return torch.stack([x, y], 1)


def so3_exp(w):
    """Rodrigues' formula."""
    th = torch.linalg.norm(w)
    K = torch.zeros((3, 3), dtype=w.dtype)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K = K - K.T
    if float(th) < 1e-12:
        return torch.eye(3, dtype=w.dtype) + K
    return (torch.eye(3, dtype=w.dtype) + torch.sin(th) / th * K
            + (1 - torch.cos(th)) / th ** 2 * (K @ K))


def frame(tc: dict, prev: dict, cur: dict, state: dict, t, imu: dict,
          R_b2c, gumbel, k: int, dtype=torch.float64) -> dict:
    """The tracker's frame k for one row: its state before (xy, uvn, desc,
    fid, t, next_id), the shared parts of frames k - 1 and k (``prepare``),
    the frame's time and IMU slab, the camera-IMU rotation and the row's
    RANSAC draws (128, 8, N). Returns the state after (xy, uvn, fid,
    next_id) and the frame's gate counts."""
    check_flags(tc)
    f = lambda x: torch.as_tensor(np.asarray(x)).to(dtype)  # noqa: E731
    N = len(state["fid"])
    fid = torch.as_tensor(state["fid"])
    xy0, uvn0 = f(state["xy"]), f(state["uvn"])
    have = fid >= 0
    # the frame's mean gyro rotates last frame's bearings to the prediction
    m = torch.as_tensor(imu["imu_mask"])
    gyro = f(imu["gyro"])[m].sum(0) / max(int(m.sum()), 1)
    dt = f(t) - f(state["t"])
    Rb = f(R_b2c)
    R = Rb @ so3_exp(gyro * dt).T @ Rb.T
    h = torch.cat([uvn0, torch.ones((N, 1), dtype=dtype)], 1) @ R.T
    fx, fy, cx, cy = tc["K"]
    pred = torch.stack([h[:, 0] / h[:, 2].clamp(min=0.1) * fx + cx,
                        h[:, 1] / h[:, 2].clamp(min=0.1) * fy + cy], 1)
    rows = torch.nonzero(have)[:, 0]
    xy = torch.zeros((N, 2), dtype=dtype)
    ok = torch.zeros(N, dtype=torch.bool)
    if len(rows):
        p, o = track(prev["pyr"], cur["pyr"], xy0[rows], pred[rows],
                     tc["patch_size"], tc["klt_iters"])
        xy[rows], ok[rows] = p, o
    tracked = have & ok
    n_lk_ok = int(tracked.sum())

    img = cur["pyr"][0]
    n_cand = tc["per_cell"] * tc["grid_rows"] * tc["grid_cols"]
    if k % tc["detect_every"] == 0:
        det_xy, det_sc, det_ok = detect(tc, img, cur["score"], xy[tracked])
    else:
        det_xy = torch.zeros((n_cand, 2), dtype=dtype)
        det_sc = torch.zeros(n_cand, dtype=dtype)
        det_ok = torch.zeros(n_cand, dtype=torch.bool)
    order = torch.argsort(-det_sc.double(), stable=True)
    det_xy, det_ok = det_xy[order], det_ok[order]

    bits = describe(img, xy[tracked])
    d_new = torch.zeros((N, 8), dtype=torch.int64)
    d_new[tracked] = words(bits)
    dist = hamming(state["desc"], d_new.numpy())
    tracked = tracked & torch.as_tensor(dist <= tc["orb_threshold"])
    n_orb_ok = int(tracked.sum())

    uvn = undistort(tc, xy)
    inl = ransac(uvn0, uvn, tracked, torch.as_tensor(gumbel).to(dtype),
                 tc["ransac_thresh"])
    tracked = tracked & inl

    free = torch.nonzero(~tracked)[:, 0]
    cand = torch.nonzero(det_ok)[:, 0][:len(free)]
    out_xy = torch.where(tracked[:, None], xy, torch.zeros_like(xy))
    out_fid = torch.where(tracked, fid, torch.full_like(fid, -1))
    nid = state["next_id"]
    for j, c in enumerate(cand.tolist()):
        out_xy[free[j]] = det_xy[c]
        out_fid[free[j]] = nid + j
    out_uvn = undistort(tc, out_xy)
    out_uvn = torch.where((out_fid >= 0)[:, None], out_uvn,
                          torch.zeros_like(out_uvn))
    return {"xy": out_xy.double().numpy(), "uvn": out_uvn.double().numpy(),
            "fid": out_fid.numpy().astype(np.int64),
            "next_id": nid + len(cand),
            "counts": {"n_lk_in": int(have.sum()), "n_lk_ok": n_lk_ok,
                       "n_orb_ok": n_orb_ok, "n_inliers": int(tracked.sum()),
                       "n_placed": len(cand)}}
