"""Dynamic (motion-based) visual-inertial initialization.

Counterpart of ``orcvio_tpu/init/dynamic.py`` (reference: the VINS-Mono
style DynamicInitializer.cpp tryDynInit / initialStructure /
visualInitialAlign, solve_5pts.cpp, initial_sfm.cpp, initial_alignment.cpp):
a window of frames with feature tracks is reconstructed up to scale
(essential-matrix relative pose, batched triangulation, batched
Gauss-Newton PnP and a Schur-complement bundle adjustment), then aligned
with the IMU preintegration by linear least squares. Iteration counts are
fixed, as in the JAX package; its ``vmap`` over frames is a batch
dimension here.

The window's RANSAC draw is ``argmax(gumbel + logits)``, as in the
tracker: ``window_sfm`` and its callers take the Gumbel noise
(``gumbel=``, tests pass the JAX package's draws) or a
``torch.Generator`` to draw it from. Factorizations (SVD) may return other
signs than JAX's; what the functions return does not depend on them. A
degenerate window (no parallax) gives NaN and ok = False, as in the JAX
package: the solves here never raise (``solve_ex``, ``inv_ex``, and an SVD
that returns NaN for a non-finite input where torch's would raise).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config.core import FilterConfig
from ..filter.state import ImuState
from ..frontend.ransac import ransac_fundamental
from ..math import se3, so3
from .preintegration import Preintegration, preintegrate_sequence


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(A, b):
    return torch.linalg.solve_ex(A, b)[0]


def _svd(A):
    """torch.linalg.svd(A, full_matrices=False) over (..., m, n), with NaN
    factors for a batch element that is not finite (torch raises there; JAX
    returns NaN)."""
    finite = torch.isfinite(A).all(dim=(-2, -1))
    U, S, Vh = torch.linalg.svd(torch.where(finite[..., None, None], A, 0.0),
                                full_matrices=False)
    nan = float("nan")
    return (torch.where(finite[..., None, None], U, nan),
            torch.where(finite[..., None], S, nan),
            torch.where(finite[..., None, None], Vh, nan))


# ---------------------------------------------------------------------------
# Two-view geometry
# ---------------------------------------------------------------------------

def decompose_essential(E, p1, p2, valid):
    """E -> (R, t) with cheirality voting. Ref: solve_5pts.cpp:29
    (recoverPose).

    Returns (R_12, t_12, n_good): the transform taking frame-1 coordinates
    to frame 2 (p2_cam = R p1_cam + t), |t| = 1."""
    U, _, Vt = _svd(E)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    t = U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    # two-view depths along f1 and f2: d1 f1 = R^T (d2 f2 - t), a 2x2
    # linear system per point and candidate
    f1 = torch.cat([p1, torch.ones_like(p1[:, :1])], dim=1)
    f2 = torch.cat([p2, torch.ones_like(p2[:, :1])], dim=1)
    Rf2 = torch.einsum("cji,nj->cni", Rs, f2)  # R^T f2
    Rt = torch.einsum("cji,cj->ci", Rs, ts)[:, None, :]  # R^T t
    a11 = torch.sum(f1 * f1, dim=1)
    a12 = -torch.sum(f1 * Rf2, dim=2)
    a22 = torch.sum(Rf2 * Rf2, dim=2)
    b1 = -torch.sum(f1 * Rt, dim=2)
    b2 = torch.sum(Rf2 * Rt, dim=2)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    d1 = (b1 * a22 - b2 * a12) / det
    d2 = (a11 * b2 - a12 * b1) / det
    counts = torch.sum((d1 > 0) & (d2 > 0) & valid, dim=1)
    best = torch.argmax(counts)
    return Rs[best], ts[best], counts[best]


def triangulate_dlt(cTw, uv, mask):
    """Batched multi-view DLT. cTw: (K, 4, 4); uv: (N, K, 2); mask: (N, K).

    Returns (p_w (N, 3), ok (N,)). Rows of the DLT system are masked to
    zero."""
    P = cTw[:, :3, :]  # (K, 3, 4)
    r1 = uv[..., 0, None] * P[None, :, 2, :] - P[None, :, 0, :]  # (N, K, 4)
    r2 = uv[..., 1, None] * P[None, :, 2, :] - P[None, :, 1, :]
    A = torch.cat([r1, r2], dim=1) * torch.cat([mask, mask], dim=1)[..., None]
    X = _svd(A)[2][:, -1, :]
    ok = torch.abs(X[:, 3]) > 1e-8
    p = X[:, :3] / torch.where(ok, X[:, 3], 1.0)[:, None]
    return p, ok & (torch.sum(mask, dim=1) >= 2)


def _dpi(pc, z):
    """d(pc_xy / z) / d pc, (..., 2, 3)."""
    inv_z = 1.0 / z
    zero = torch.zeros_like(z)
    return torch.stack([
        torch.stack([inv_z, zero, -pc[..., 0] * inv_z**2], -1),
        torch.stack([zero, inv_z, -pc[..., 1] * inv_z**2], -1),
    ], dim=-2)


def pnp_gn(p_w, uv, mask, cTw0, iters: int = 10):
    """Pose-only Gauss-Newton refinement of cTw, batched over leading
    dimensions of uv (..., N, 2), mask (..., N) and cTw0 (..., 4, 4);
    p_w (N, 3). Returns (cTw, the last step's squared residual)."""
    cTw = cTw0
    m = mask.to(uv.dtype)
    for _ in range(iters):
        R, t = cTw[..., :3, :3], cTw[..., :3, 3]
        pc = torch.einsum("...ij,nj->...ni", R, p_w) + t[..., None, :]
        z = torch.clamp(pc[..., 2], min=1e-3)
        r = (uv - pc[..., :2] / z[..., None]) * m[..., None]
        # d pc / d xi = [I | -hat(pc)] (left perturbation cTw' = exp(xi) cTw)
        dpc = torch.cat([_eye(3, pc).expand(pc.shape + (3,)), -so3.hat(pc)],
                        dim=-1)
        J = (_dpi(pc, z) @ dpc) * m[..., None, None]  # (..., N, 2, 6)
        A = torch.einsum("...nik,...nil->...kl", J, J) + 1e-8 * _eye(6, pc)
        b = torch.einsum("...nik,...ni->...k", J, r)
        xi = _solve(A, b)
        cost = torch.sum(r * r, dim=(-2, -1))
        cTw = se3.exp(xi) @ cTw
    return cTw, cost


# ---------------------------------------------------------------------------
# Window SfM + alignment
# ---------------------------------------------------------------------------

def bundle_adjust(cTw, p_w, uv, mask, fixed_frame: int, iters: int = 12,
                  lam: float = 1e-4):
    """Joint pose and point Gauss-Newton with the point-block Schur
    complement (the reference's Ceres BA, initial_sfm.h:70): per-point 3x3
    blocks are eliminated in closed form, leaving one dense 6K x 6K pose
    system per iteration. The monocular scale gauge is held by damping and
    by renormalizing the trajectory's extent. Returns (cTw, p_w, costs)."""
    N, K, _ = uv.shape
    anchor_extent = torch.linalg.norm(se3.inverse_pose(cTw)[K - 1, :3, 3])
    m = mask.to(uv.dtype)
    eye3, eye6 = _eye(3, uv), _eye(6, uv)
    costs = []
    for _ in range(iters):
        R, t = cTw[:, :3, :3], cTw[:, :3, 3]
        pc = torch.einsum("kij,nj->nki", R, p_w) + t[None]  # (N, K, 3)
        z = torch.clamp(pc[..., 2], min=1e-3)
        r = (uv - pc[..., :2] / z[..., None]) * m[..., None]  # (N, K, 2)
        dpi = _dpi(pc, z)  # (N, K, 2, 3)
        dpc_pose = torch.cat([eye3.expand(pc.shape + (3,)), -so3.hat(pc)],
                             dim=-1)  # (N, K, 3, 6)
        Jx = (dpi @ dpc_pose) * m[..., None, None]  # (N, K, 2, 6)
        Jp = torch.einsum("nkij,kjl->nkil", dpi, R) * m[..., None, None]

        U = torch.einsum("nkia,nkib->kab", Jx, Jx)  # (K, 6, 6)
        V = torch.einsum("nkia,nkib->nab", Jp, Jp)  # (N, 3, 3)
        Wb = torch.einsum("nkia,nkib->knab", Jx, Jp)  # (K, N, 6, 3)
        gx = torch.einsum("nkia,nki->ka", Jx, r)  # (K, 6)
        gp = torch.einsum("nkia,nki->na", Jp, r)  # (N, 3)

        Vinv = torch.linalg.inv_ex(V + (lam + 1e-6) * eye3)[0]  # (N, 3, 3)
        # Schur: S_{k,k'} = U_k delta - sum_n W_{k,n} Vinv_n W_{k',n}^T
        WVi = torch.einsum("knab,nbc->knac", Wb, Vinv)  # (K, N, 6, 3)
        S = -torch.einsum("knac,lnbc->klab", WVi, Wb)  # (K, K, 6, 6)
        ar = torch.arange(K, device=uv.device)
        S[ar, ar] += U + lam * eye6
        rhs = gx - torch.einsum("knac,nc->ka", WVi, gp)  # (K, 6)
        # fix the gauge frame: identity row and column
        S[fixed_frame, :] = 0.0
        S[:, fixed_frame] = 0.0
        S[fixed_frame, fixed_frame] = eye6
        rhs[fixed_frame] = 0.0
        Sd = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
        dx = _solve(Sd, rhs.reshape(-1)).reshape(K, 6)
        # back-substitute the points
        dp = torch.einsum("nab,nb->na", Vinv,
                          gp - torch.einsum("knab,ka->nb", Wb, dx))
        wTc2 = se3.inverse_pose(se3.exp(dx) @ cTw)
        # renormalize the scale gauge to the anchor extent
        ext = torch.clamp(torch.linalg.norm(wTc2[K - 1, :3, 3]), min=1e-9)
        scale = anchor_extent / ext
        wTc2 = torch.cat([wTc2[:, :3, :3], wTc2[:, :3, 3:] * scale], dim=-1)
        cTw = se3.inverse_pose(wTc2)
        p_w = (p_w + dp) * scale
        costs.append(torch.sum(r * r))
    return cTw, p_w, torch.stack(costs)


class SfmResult(NamedTuple):
    R_c0_ck: torch.Tensor  # (K, 3, 3) camera k rotation in the c0 (ref) frame
    p_c0_ck: torch.Tensor  # (K, 3) camera centers, unscaled
    ok: torch.Tensor


def window_sfm(uv, obs_mask, gumbel=None, generator=None,
               parallax_ref: int = 0):
    """Up-to-scale reconstruction of a K-frame window.

    uv: (N, K, 2) normalized feature tracks; obs_mask: (N, K). Frame
    `parallax_ref` and the last frame anchor the relative pose
    (DynamicInitializer.cpp:330 relativePose). gumbel: optional
    (256, 8, N) RANSAC noise, else drawn from `generator`. Returns
    (SfmResult, p_w (N, 3), ok3d (N,))."""
    N, K, _ = uv.shape
    l = parallax_ref
    both = obs_mask[:, l] & obs_mask[:, K - 1]
    p1, p2 = uv[:, l], uv[:, K - 1]
    inl, E = ransac_fundamental(p1, p2, both, gumbel=gumbel,
                                generator=generator, n_hyp=256, thresh=3e-5)
    R_rel, t_rel, n_good = decompose_essential(E, p1, p2, inl)
    # camera l = identity; camera K-1: p2_cam = R_rel p1_cam + t_rel, so
    # its cTw (world = camera-l frame) is [R_rel | t_rel]
    eye = _eye(4, uv)
    cTw = eye.repeat(K, 1, 1)
    cTw[K - 1, :3, :3] = R_rel
    cTw[K - 1, :3, 3] = t_rel

    # triangulate from the anchor pair, then PnP every other frame, then
    # re-triangulate with all poses and re-PnP (2 sweeps of alternation)
    pair = torch.zeros_like(obs_mask)
    pair[:, l] = both
    pair[:, K - 1] = both
    p_w, ok3d = triangulate_dlt(cTw, uv, pair & inl[:, None])
    for _ in range(2):
        # every frame at once, from its previous estimate
        cTw = pnp_gn(p_w, uv.transpose(0, 1),
                     obs_mask.T & ok3d[None, :], cTw)[0]
        cTw[l] = eye  # keep the anchor frame at identity (gauge)
        p_w, ok3d = triangulate_dlt(cTw, uv, obs_mask)

    # joint refinement (the reference's Ceres BA stage, initial_sfm.h:70)
    cTw, p_w, _ = bundle_adjust(cTw, p_w, uv, obs_mask & ok3d[:, None],
                                fixed_frame=l)
    wTc = se3.inverse_pose(cTw)
    ok = (n_good > 12) & (torch.sum(ok3d) > 20)
    return SfmResult(R_c0_ck=wTc[:, :3, :3], p_c0_ck=wTc[:, :3, 3],
                     ok=ok), p_w, ok3d


def solve_gyro_bias(pre: Preintegration, R_b_seq, gap_mask):
    """Gyro bias from rotation consistency (initial_alignment.cpp
    solveGyroscopeBias). R_b_seq: (K, 3, 3) body rotations from vision;
    gap k uses preintegration row k (gap k-1 -> k)."""
    dR_vis = torch.einsum("kji,kjl->kil", R_b_seq[:-1], R_b_seq[1:])
    r = so3.log(torch.einsum("kji,kjl->kil", pre.dR[1:], dR_vis))
    J = pre.J_q_bg[1:]  # (K-1, 3, 3)
    m = gap_mask[1:].to(r.dtype)
    A = torch.einsum("kij,kil,k->jl", J, J, m) + 1e-8 * _eye(3, r)
    b = torch.einsum("kij,ki,k->j", J, r, m)
    return _solve(A, b)


def linear_alignment(pre: Preintegration, R_c0_bk, p_c0_ck, t_c_b_in_body,
                     dt_gaps, gap_mask, gravity=9.81):
    """Velocities, gravity (in c0) and scale (initial_alignment.cpp
    LinearAlignment). R_c0_bk: (K, 3, 3) body-to-c0 rotations; p_c0_ck:
    (K, 3) camera centres (unscaled); t_c_b_in_body: the camera position
    in the body frame. Unknowns x = [v_b0..v_b{K-1} (3K), g_c0 (3), s].
    Returns (vels, g_c0, s, ok)."""
    K = R_c0_bk.shape[0]
    n_x = 3 * K + 4
    eye3 = _eye(3, p_c0_ck)
    H = torch.zeros((K - 1, 2, 3, n_x), dtype=p_c0_ck.dtype,
                    device=p_c0_ck.device)
    b = torch.zeros((K - 1, 2, 3), dtype=p_c0_ck.dtype,
                    device=p_c0_ck.device)
    for k in range(K - 1):
        dt = dt_gaps[k + 1]
        Rk_inv = R_c0_bk[k].T  # c0 -> bk
        H[k, 0, :, 3 * k:3 * k + 3] = -dt * eye3
        H[k, 0, :, 3 * K:3 * K + 3] = 0.5 * dt * dt * Rk_inv
        H[k, 0, :, 3 * K + 3] = Rk_inv @ (p_c0_ck[k + 1] - p_c0_ck[k])
        b[k, 0] = (pre.dp[k + 1] + Rk_inv @ R_c0_bk[k + 1] @ t_c_b_in_body
                   - t_c_b_in_body)
        H[k, 1, :, 3 * k:3 * k + 3] = -eye3
        H[k, 1, :, 3 * (k + 1):3 * (k + 1) + 3] = Rk_inv @ R_c0_bk[k + 1]
        H[k, 1, :, 3 * K:3 * K + 3] = dt * Rk_inv
        b[k, 1] = pre.dv[k + 1]
    m = gap_mask[1:].to(H.dtype)
    H = (H * m[:, None, None, None]).reshape(-1, n_x)
    b = (b * m[:, None, None]).reshape(-1)
    x = _solve(H.T @ H + 1e-10 * _eye(n_x, H), H.T @ b)
    vels = x[:3 * K].reshape(K, 3)
    g_c0 = x[3 * K:3 * K + 3]
    s = x[3 * K + 3]
    ok = (s > 1e-3) & (torch.abs(torch.linalg.norm(g_c0) - gravity)
                       < 0.5 * gravity)
    return vels, g_c0, s, ok


class DynamicInitResult(NamedTuple):
    imu: ImuState  # gravity-aligned initial state at the LAST window frame
    scale: torch.Tensor
    ok: torch.Tensor


def dynamic_initialize(cfg: FilterConfig, uv, obs_mask, imu_t, gyro, acc,
                       imu_mask, R_b2c, t_c_b, gumbel=None, generator=None):
    """Full dynamic init over a K-frame window (tryDynInit,
    DynamicInitializer.cpp:20).

    uv: (N, K, 2) tracks; IMU slabs (K, S, ...): slab k covers gap
    (k-1, k]. Returns the initial ImuState in a gravity-aligned world frame
    whose origin and yaw are the last window camera's (up to the monocular
    gauge)."""
    K = uv.shape[1]
    sfm, _, _ = window_sfm(uv, obs_mask, gumbel=gumbel, generator=generator)
    # wTc = wTb bTc with bTc = (R_b2c^T, t_c_b) => R_c0_bk = R_c0_ck R_b2c
    R_c0_bk = torch.einsum("kij,jl->kil", sfm.R_c0_ck, R_b2c)

    pre0 = preintegrate_sequence(imu_t, gyro, acc, imu_mask)
    gap_mask = torch.sum(imu_mask, dim=1) > 0
    dbg = solve_gyro_bias(pre0, R_c0_bk, gap_mask)
    pre = preintegrate_sequence(imu_t, gyro, acc, imu_mask, bg=dbg)
    vels, g_c0, s, align_ok = linear_alignment(
        pre, R_c0_bk, sfm.p_c0_ck, t_c_b, pre.dt, gap_mask, cfg.gravity)

    # gravity-align: the solved g_c0 is the NEGATIVE of the world gravity
    # vector (dv = R^T (dv_w - g_w dt) puts it on the + side of the linear
    # model); map it to +z, as the reference's g2R does
    a = g_c0 / torch.clamp(torch.linalg.norm(g_c0), min=1e-9)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=uv.dtype, device=uv.device)
    v = torch.linalg.cross(a, ez)
    vn = torch.linalg.norm(v)
    axis = torch.where(vn > 1e-9, v / torch.clamp(vn, min=1e-9),
                       torch.tensor([1.0, 0, 0], dtype=uv.dtype,
                                    device=uv.device))
    R_w_c0 = so3.exp(axis * torch.atan2(vn, torch.dot(a, ez)))

    R0 = R_w_c0 @ R_c0_bk[K - 1]
    v0 = R_w_c0 @ R_c0_bk[K - 1] @ vels[K - 1]
    z3 = torch.zeros(3, dtype=uv.dtype, device=uv.device)
    imu0 = ImuState(R=R0, v=v0, p=z3, bg=dbg, ba=z3)
    ok = (sfm.ok & align_ok & torch.all(torch.isfinite(R0))
          & torch.all(torch.isfinite(v0)))
    return DynamicInitResult(imu=imu0, scale=s, ok=ok)


def build_tracks(fids, uvs, meas_mask, n_cap: int = 80):
    """Stack per-frame (fid, uv) measurements into (N, K, 2) tracks: the
    ids seen in at least 2 frames, most-observed first, at most n_cap
    (N >= 8). Host-side numpy (feature_manager.h:88).
    fids/uvs/meas_mask: (K, M[, 2]) arrays."""
    fids = np.asarray(fids)
    uvs = np.asarray(uvs)
    meas_mask = np.asarray(meas_mask)
    K = fids.shape[0]
    counts = {}
    for k in range(K):
        for f in fids[k][meas_mask[k]]:
            counts[int(f)] = counts.get(int(f), 0) + 1
    ids = [f for f, c in sorted(counts.items(), key=lambda kv: -kv[1])
           if c >= 2][:n_cap]
    id_to_row = {f: i for i, f in enumerate(ids)}
    N = max(len(ids), 8)
    uv = np.zeros((N, K, 2))
    m = np.zeros((N, K), bool)
    for k in range(K):
        for j in range(fids.shape[1]):
            f = int(fids[k, j])
            if meas_mask[k, j] and f in id_to_row:
                uv[id_to_row[f], k] = uvs[k, j]
                m[id_to_row[f], k] = True
    return uv, m


def window_tracks(window_frames):
    """build_tracks on a list of FrameInput: (uv, mask) numpy arrays."""
    return build_tracks(*(np.stack([getattr(f, name).cpu().numpy()
                                    for f in window_frames])
                          for name in ("fids", "uvs", "meas_mask")))


def flexible_dynamic_attempt(cfg, window_frames, R_b2c, t_c_b, gumbel=None,
                             generator=None, min_tracks: int = 25):
    """One dynamic-init attempt over a list of FrameInput (the
    FlexibleInitializer fallback, FlexibleInitializer.cpp:10-26), called by
    the runner while static init has not fired. Returns a
    DynamicInitResult, or None where the window has too few tracks.
    gumbel: optional (256, 8, N) RANSAC noise for the N rows of
    ``window_tracks(window_frames)``."""
    uv, m = window_tracks(window_frames)
    if m.sum() < min_tracks * 2:
        return None
    dev, dtype = window_frames[0].imu_gyro.device, \
        window_frames[0].imu_gyro.dtype
    imu = (torch.stack([getattr(f, name) for f in window_frames])
           for name in ("imu_t", "imu_gyro", "imu_acc", "imu_mask"))
    return dynamic_initialize(
        cfg, torch.as_tensor(uv).to(dev, dtype), torch.as_tensor(m).to(dev),
        *imu, torch.as_tensor(R_b2c).to(dev, dtype),
        torch.as_tensor(t_c_b).to(dev, dtype), gumbel=gumbel,
        generator=generator)
