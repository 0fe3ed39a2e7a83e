"""Object initialization: per-keypoint triangulation and a Kabsch/Umeyama
fit.

Counterpart of ``orcvio_tpu/objects/init.py`` (reference:
``src/obj/ObjectFeatureInitializer.cpp``: ``single_object_initialization``
:33, which triangulates each semantic keypoint across frames and fits the
similarity from the class mean shape to the triangulated keypoints,
``findTransform`` :267, Kabsch with scale, and its RANSAC over C(K, 3)
triples :120-240). All keypoints triangulate at once through the filter's
masked LM; all RANSAC hypotheses are one batched SVD, whose inputs are
guarded: a non-finite matrix gives NaN factors (torch raises there, JAX
returns NaN).
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ..config.core import FilterConfig
from ..filter.state import take
from ..filter.tracks import CompactTracks
from ..filter.triangulation import triangulate
from ..math import se3
from . import residuals as RS


def _svd(A):
    """torch.linalg.svd over (..., 3, 3), NaN factors where A is not
    finite."""
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    U, S, Vh = torch.linalg.svd(torch.where(finite[..., None, None], A, 0.0))
    nan = float("nan")
    return (torch.where(finite[..., None, None], U, nan),
            torch.where(finite[..., None], S, nan),
            torch.where(finite[..., None, None], Vh, nan))


def det3(A):
    """Determinant of (..., 3, 3) by cofactors."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def nanmedian(x, dim: int):
    """Median over `dim` ignoring NaN, the mean of the two middle values
    for an even count (numpy's and JAX's; torch.nanmedian takes the lower
    one); NaN where every value is NaN."""
    n = torch.sum(~torch.isnan(x), dim=dim, keepdim=True)
    s = torch.sort(torch.where(torch.isnan(x), torch.inf, x), dim=dim).values
    lo = torch.take_along_dim(s, torch.clamp((n - 1) // 2, min=0), dim=dim)
    hi = torch.take_along_dim(s, torch.clamp(n // 2, max=x.shape[dim] - 1),
                              dim=dim)
    return torch.where(n > 0, 0.5 * (lo + hi), torch.nan).squeeze(dim)


def _reprojection(ct, R_c2w, t_c_w, p_world):
    """|z_hat - uv| (K, T) of each keypoint's observations."""
    sl = torch.clamp(ct.slot, 0, R_c2w.shape[0] - 1)
    pc = torch.einsum("ktji,ktj->kti", R_c2w[sl], p_world[:, None] - t_c_w[sl])
    zh = pc[..., :2] / torch.clamp(pc[..., 2:3], min=1e-3)
    return torch.linalg.norm(zh - ct.uv, dim=-1)


def triangulate_keypoints(cfg: FilterConfig, zs, zs_mask, R_c2w, t_c_w,
                          p_init_world=None, trim: bool = True,
                          trim_floor: float = 0.02):
    """Triangulate each semantic keypoint across frames. zs (T, K, 2)
    normalized measurements, zs_mask (T, K), camera poses (T, 3, 3) and
    (T, 3). Returns (p_world (K, 3), valid (K,)). Ref:
    single_object_initialization's keypoint loop
    (ObjectFeatureInitializer.cpp:44-80)."""
    uv = zs.transpose(0, 1)  # (K, T, 2): the keypoints as tracks
    mask = zs_mask.transpose(0, 1)
    # the anchor logic wants a valid prefix: valid entries first, in time
    # order (a stable sort)
    order = torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices
    uv_c = torch.take_along_dim(uv, order[..., None], dim=1)
    mask_c = torch.take_along_dim(mask, order, dim=1)
    ct = CompactTracks(uv=uv_c, uv_vel=torch.zeros_like(uv_c), slot=order,
                       mask=mask_c,
                       n_obs=torch.sum(mask_c, dim=1).to(torch.int32))

    def med_res(p_world):
        return nanmedian(torch.where(ct.mask, _reprojection(
            ct, R_c2w, t_c_w, p_world), torch.nan), dim=1)

    tri = triangulate(cfg, ct, R_c2w, t_c_w)
    valid = tri.valid & (ct.n_obs >= 2)
    p_world = tri.p_world
    if p_init_world is not None:
        # the bbox depth prior rescues degenerate two-view starts but can
        # steer good tracks into worse minima: solve both ways and keep,
        # per keypoint, the valid solution of the lower median residual
        tri_p = triangulate(cfg, ct, R_c2w, t_c_w, p_init_world=p_init_world)
        valid_p = tri_p.valid & (ct.n_obs >= 2)
        m0 = torch.where(valid, med_res(p_world), torch.inf)
        m1 = torch.where(valid_p, med_res(tri_p.p_world), torch.inf)
        p_world = torch.where((m1 < m0)[:, None], tri_p.p_world, p_world)
        valid = valid | valid_p
    if not trim:
        return p_world, valid

    # a second pass without the observations whose residual exceeds
    # max(3 x the track's median, trim_floor): identity-swapped keypoints
    # lie far beyond what the LM's Huber weights absorb
    res = _reprojection(ct, R_c2w, t_c_w, p_world)
    med = nanmedian(torch.where(ct.mask, res, torch.nan), dim=1)
    thr = torch.clamp(3.0 * med, min=trim_floor)[:, None]
    keep = ct.mask & (res < thr)
    ct2 = ct._replace(mask=keep, n_obs=torch.sum(keep, dim=1).to(torch.int32))
    tri2 = triangulate(cfg, ct2, R_c2w, t_c_w, p_init_world=p_world)
    valid2 = tri2.valid & (ct2.n_obs >= 2)
    # keep pass 1 where trimming took too much
    use2 = valid2 & (ct2.n_obs >= torch.clamp(ct.n_obs // 2, min=2))
    return (torch.where(use2[:, None], tri2.p_world, p_world),
            torch.where(use2, valid2, valid))


def kabsch_umeyama(src, dst, mask):
    """Similarity transform dst ~ s R src + t as one (..., 4, 4) with the
    scaled rotation, as the reference's findTransform
    (ObjectFeatureInitializer.cpp:267). src, dst (..., N, 3); mask (..., N).
    The scale is the ratio of summed pairwise distances over all valid
    pairs (the reference's consecutive pairs give 0/0 on a scattered
    subset such as a RANSAC inlier set); the SVD rotation has its
    determinant fixed."""
    m = mask[..., None].to(src.dtype)
    n = torch.clamp(torch.sum(mask, dim=-1), min=1)[..., None]
    pair_ok = (mask[..., :, None] & mask[..., None, :])[..., None]

    def spread(x):
        return torch.sum(torch.linalg.norm(
            (x[..., :, None, :] - x[..., None, :, :]) * pair_ok, dim=-1),
            dim=(-1, -2))

    scale = spread(dst) / torch.clamp(spread(src), min=1e-9)
    dst_s = dst / scale[..., None, None]
    mu_s = torch.sum(src * m, dim=-2) / n
    mu_d = torch.sum(dst_s * m, dim=-2) / n
    sc = (src - mu_s[..., None, :]) * m
    dc = (dst_s - mu_d[..., None, :]) * m
    cov = torch.einsum("...ni,...nj->...ij", sc, dc)
    U, _, Vt = _svd(cov)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = torch.sign(det3(V @ Ut))
    one = torch.ones_like(d)
    R = V @ torch.diag_embed(torch.stack([one, one, d], dim=-1)) @ Ut
    t = scale[..., None] * (mu_d - torch.einsum("...ij,...j->...i", R, mu_s))
    return se3.make_pose(scale[..., None, None] * R, t)


@functools.lru_cache(maxsize=None)
def _combos(n: int, device: torch.device):
    """The C(n, 3) triples in itertools' order, a tensor made on `device`
    once (so the frame loop copies nothing to the card); never written."""
    return torch.as_tensor(np.asarray(list(itertools.combinations(
        range(n), 3)), np.int64), device=device)


def kabsch_ransac(mean_shape, world_kps, valid, inlier_threshold=1.5,
                  min_inliers=3):
    """RANSAC Kabsch over all C(K, 3) triples. mean_shape, world_kps
    (K, 3); valid (K,). Returns (wTq (4, 4), ok). Ref:
    ObjectFeatureInitializer.cpp:120-240. Hypotheses with an invalid
    keypoint are masked out. As in the JAX package, the inlier distance
    is object-scale (half a car), not the reference's 20 m (:211), so
    that the triples' consensus rejects identity-swapped keypoints."""
    combos = _combos(mean_shape.shape[0], mean_shape.device)
    src = mean_shape[combos]
    dst = world_kps[combos]
    hyp_ok = torch.all(valid[combos], dim=1)
    T_h = kabsch_umeyama(src, dst, torch.ones(combos.shape, dtype=torch.bool,
                                              device=combos.device))
    pred = (torch.einsum("cij,kj->cki", T_h[:, :3, :3], mean_shape)
            + T_h[:, None, :3, 3])
    dist = torch.linalg.norm(pred - world_kps[None], dim=-1)
    inl = (dist < inlier_threshold) & valid[None, :]
    n_inl = torch.sum(inl, dim=1)
    # rank by inlier count, ties broken by the mean inlier distance
    mean_d = torch.sum(torch.where(inl, dist, 0.0), dim=1) / torch.clamp(
        n_inl, min=1)
    scores = torch.where(hyp_ok, n_inl - mean_d / inlier_threshold,
                         -torch.inf)
    best_inl = take(inl, torch.argmax(scores)) & valid
    ok = torch.sum(best_inl) >= min_inliers
    return kabsch_umeyama(mean_shape, world_kps, best_inl), ok


def first_index(mask):
    """Index of the first True of a 1-d mask (0 where there is none), as a
    0-d tensor: JAX's argmax of a boolean array."""
    return torch.argmax(mask.to(torch.uint8))


def object_initialization(cfg: FilterConfig, zs, zs_mask, R_c2w, t_c_w,
                          mean_shape, use_ransac=True, estimate_se2=False,
                          zb=None, zb_mask=None, shape_ellipsoid=None):
    """Triangulate the keypoints, fit Kabsch (with RANSAC), optionally
    flatten to SE(2). Ref: single_object_initialization
    (ObjectFeatureInitializer.cpp:33-199). Returns (wTq (4, 4), success,
    kps_world (K, 3), kps_valid (K,)).

    Given the frames' bboxes (zb (T, 4), zb_mask (T,)) and the class
    ellipsoid (shape_ellipsoid (3,)), the bbox-only lite geometry
    (ObjectFeatureInitializer.cpp:497) gives every keypoint's
    triangulation its starting depth."""
    K = zs.shape[1]
    p_init = None
    if zb is not None and shape_ellipsoid is not None:
        first = first_index(zb_mask)
        wTq_lite, lite_ok = object_initialization_lite(
            take(zb, first), take(R_c2w, first).T, take(t_c_w, first),
            shape_ellipsoid)
        have = lite_ok & torch.any(zb_mask)
        p_init = torch.where(have, wTq_lite[:3, 3], torch.nan).expand(K, 3)
    kps_w, kps_valid = triangulate_keypoints(cfg, zs, zs_mask, R_c2w, t_c_w,
                                             p_init_world=p_init)
    # outliers are left to the object-scale RANSAC consensus
    enough = torch.sum(kps_valid) > 3  # num_valid_pts_threshold (:82)
    if use_ransac:
        wTq, ok = kabsch_ransac(mean_shape, kps_w, kps_valid)
    else:
        wTq = kabsch_umeyama(mean_shape, kps_w, kps_valid)
        ok = torch.ones((), dtype=torch.bool, device=zs.device)
    if estimate_se2:
        wTq = se3.pose_se3_to_se2(wTq)
    return wTq, enough & ok, kps_w, kps_valid


def object_initialization_lite(zb_first, R_GtoA, p_AinG, mean_shape,
                               bbox_scale=(1.0, 1.0, 1.0), estimate_se2=False):
    """Bbox-only object init from the first observation. Ref:
    single_object_initialization_lite (ObjectFeatureInitializer.cpp:497):
    the object's rotation is the identity, and the depth d along the
    bbox-centre ray makes the mean-shape ellipsoid's projection touch the
    bbox's edge lines; wPq = d B^-1 b - the camera centre, B = R_GtoA.
    zb_first (4,) normalized bbox; R_GtoA, p_AinG the first camera's pose.
    Returns (wTq (4, 4), ok)."""
    dtype, dev = zb_first.dtype, zb_first.device
    vv = torch.cat([mean_shape[i:i + 1] * b for i, b in enumerate(
        bbox_scale)]) ** 2
    A = torch.diag(vv)  # wRq = I
    B = R_GtoA  # K = I (normalized coordinates)
    lines = RS.bbox_lines(zb_first[None])[0]
    line_sum = lines.T @ lines
    denominator = torch.einsum("ni,ij,jk,kl,nl->", lines, B, A, B.T, lines)
    E = B.T @ line_sum @ B / torch.clamp(denominator, min=1e-12)
    center = torch.stack([(zb_first[0] + zb_first[2]) / 2,
                          (zb_first[1] + zb_first[3]) / 2,
                          torch.ones_like(zb_first[0])])
    Binv = torch.linalg.inv_ex(B)[0]
    q = center @ Binv.T @ E @ Binv @ center
    d = 1.0 / torch.sqrt(torch.clamp(q, min=1e-12))
    cPw = -R_GtoA @ p_AinG
    wPq = d * Binv @ center - R_GtoA.T @ cPw
    wTq = se3.make_pose(torch.eye(3, dtype=dtype, device=dev), wPq)
    if estimate_se2:
        wTq = se3.pose_se3_to_se2(wTq)
    return wTq, torch.all(torch.isfinite(wPq)) & (q > 1e-12)
