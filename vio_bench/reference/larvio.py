"""The plain reference of the end-to-end cells' back end: one frame of the
LARVIO hybrid filter (MSCKF updates with 1-d inverse-depth features in
the state), the ZUPT update and static initialization, in NumPy, written
from the estimator's equations, one IMU sample and one feature at a time.
It imports nothing of the port; it builds on ``msckf.py``'s helpers (SO(3),
clone augmentation, the feature table's ingest, triangulation, the
MSCKF rows, the gate, the prune choice and the clone drop), which compute
the same equations for both filters.

The stages and what each is written from (the upstream orcvio.cpp, whose
LARVIO branch follows Qiu et al.'s LARVIO):

- propagation (batchImuProcessing :664, predictNewStateLARVIO :825,
  calPhiClosedForm :3980): per IMU sample, the RK4 mean on rotation
  matrices with the exact half- and full-step attitudes,
      R' = R exp(w dt), v' = v + dt / 6 (k1 + 4 k2 + k4),
      p' = p + v dt + dt^2 / 6 (k1 + 2 k2), k_i = R_i a + g,
  and the closed-form transition Phi of the leg with the noise input
  G = [-R; -R; I; I] (theta, v, bg, ba), P <- Phi P Phi^T + Phi G Qc G^T
  Phi^T dt;
- the clone, the measurements, the MSCKF rows and their chi-square gate
  (stateAugmentation :930, addFeatureObservations :1016,
  measurementJacobian_msckf :1071 with LARVIO's clone block
  [R_w2c hat(p_w - p_b) | -R_w2c], featureJacobian_msckf :1171,
  gatingTestFeature :1953), in ``msckf.py``;
- ZUPT (checkZUPTFeat :3081, checkZUPTIMU :3129,
  measurementUpdate_ZUPT_vpq :3326): the feature test (20 tracks, the 9th
  largest motion between each track's two newest observations under
  zupt_max_feature_dis) or the IMU test (chi-square of R (a - ba) + g ~ 0
  against the marginal covariance of [theta, bg, ba]), then the update of
  v ~ 0, p_cur - p_prev ~ 0 and the vector part of q_cur q_prev^-1 ~ 0;
- the hybrid update (measurementUpdate_hybrid :1766): the finished
  tracks' MSCKF rows, the tracked in-state features' two rows against the
  current clone, their anchor clone and their inverse depth rho
  (measurementJacobian_ekf_1didp :1356), and, for up to 4 tracks that
  grew to max_track_len, the rows free of their rho, stacked into one EKF
  update; then each of them joins the state (:1824-1920) with
  rho += (r1 - H1 dx) / H2, P_fx = -H2^-1 H1 P, P_ff = H2^-1 H1 P H1^T
  H2^-T + sigma^2 (H2^T H2)^-1, (H1, H2, r1) the rho-bearing row;
- removal of lost features and of those whose anchor died
  (rmLostFeaturesCov :3776), the prune of two clones (findRedundantImuStates
  :2582, pruneImuStateBuffer :2629) after the last-chance update on their
  observations (:2803-2851), and the anchor change of the features whose
  anchor is pruned (:2666-2725, updateFeatureCov_1didp :3611): the
  feature's new inverse depth in the current camera and P transformed by
  its derivative with respect to [rho, old anchor, new anchor,
  extrinsics];
- static initialization (StaticInitializer.cpp:77-135): the gyro bias the
  mean angular rate since the first frame, the attitude the shortest
  rotation taking the mean specific force to +z.

Where the port departs from the upstream on purpose, this computes the
port's documented semantics from its definition:

- LARVIO's transition, clone Jacobians and corrections take the left
  convention (R <- exp(dtheta) R) whatever use_left_perturbation says; the
  flag reaches the ZUPT IMU test's orientation column alone, R hat(a)
  where it is false;
- the covariance's extrinsic and time-offset block stays zero (they are
  not estimated), so their columns are left out of every row;
- the 1-d feature rows leave out the observation in the feature's own
  anchor camera; the join regularizes H2 by 1e-10 and takes H2's sign
  from the first row as a Householder reflection gives it;
- the ZUPT IMU test's gyro rows are zero, its noise OpenVINS's constants
  (sigma_w 1.6968e-4, sigma_a 2e-3, bias walks 1.9393e-5 and 3e-3 taken
  times the slab's span), its velocity bound 0.25 m/s, and the ZUPT
  update's noises 1e-2; the last-chance update is skipped on a ZUPT frame;
- the join takes at most 4 features a frame and only into free slots, the
  lowest first; a re-anchored feature whose new depth is under 1e-3 m is
  removed.

``dtype`` sets the precision every float is computed in: float64 is the
reference, float32 the control one step below.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.stats import chi2

from . import msckf as m

LEG = m.LEG
# checkZUPTIMU's constants (orcvio.cpp:3140-3152) and the ZUPT noises
SIGMA_W2, SIGMA_A2 = 1.6968e-4 ** 2, 2.0e-3 ** 2
SIGMA_WB, SIGMA_AB = 1.9393e-05, 3.0e-03
ZUPT_MAX_V = 0.25
ZUPT_NOISE = (1e-2, 1e-2, 1e-2)  # v, p, q
JOIN_MAX = 4
STATE_KEYS = m.STATE_KEYS + ("in_state", "state_slot", "anchor_slot", "idp")

_FLAGS = {"use_larvio": True, "use_closed_form_cov_prop": True,
          "if_fej": False, "estimate_extrinsic": False,
          "estimate_td": False, "if_zupt": True, "use_schmidt": False,
          "calib_imu": False, "prediction_only": False,
          "update_form": "direct", "joseph_form": False,
          "prune_last_chance": True, "feature_idp_dim": 1,
          "nuisance_cap": 0}


def check_flags(f: dict) -> None:
    """Raise where the configuration asks for a path this reference does
    not compute."""
    wrong = {k: f.get(k) for k, v in _FLAGS.items() if f.get(k) != v}
    if f.get("tri_translation_threshold", 0.0) >= 0:  # checkMotion on
        wrong["tri_translation_threshold"] = f.get("tri_translation_threshold")
    if f.get("ekf_feature_cap", 0) < 1:
        wrong["ekf_feature_cap"] = f.get("ekf_feature_cap")
    if wrong:
        raise ValueError(f"the LARVIO reference covers {_FLAGS}; got {wrong}")


def _cast(d: dict, dtype) -> dict:
    return {k: (np.array(v, dtype) if np.asarray(v).dtype.kind == "f"
                else np.array(v)) for k, v in d.items()}


# --- propagation ---

def phi_closed_form(C, dt, w, w_old, v0, p0, v1, p1, g):
    """The leg's closed-form transition over one sample (calPhiClosedForm,
    orcvio.cpp:3980, left convention): C the attitude before the sample,
    w and w_old this and the last sample's bias-corrected rates."""
    dtp = C.dtype
    I3 = np.eye(3, dtype=dtp)
    A = m.hat(dt * (w_old + w) / 2 + dt * dt * np.cross(w_old, w) / 12)
    h = m.hat
    Phi = np.eye(LEG, dtype=dtp)
    Phi[0:3, 9:12] = -0.5 * C @ (2 * I3 + A) * dt
    Phi[3:6, 0:3] = -h(v1 - v0 - g * dt)
    Phi[3:6, 9:12] = (h(-p1 + p0 + v1 * dt - 0.5 * g * dt * dt) @ C
                      + h(-0.5 * p1 + 0.5 * p0 + 0.5 * v1 * dt
                          - g * dt * dt / 6) @ C @ A)
    Phi[3:6, 12:15] = -0.5 * C @ (2 * I3 + A) * dt
    Phi[6:9, 0:3] = -h(p1 - p0 - v0 * dt - 0.5 * g * dt * dt)
    Phi[6:9, 3:6] = dt * I3
    Phi[6:9, 9:12] = (-(dt ** 3) * h(g) @ C / 6
                      + dt * h(p1 - p0 - g * dt * dt / 6) @ C @ A / 4)
    Phi[6:9, 12:15] = -C @ (3 * I3 + A) * dt * dt / 6
    return Phi


def propagate(f: dict, s: dict, fr: dict) -> None:
    """The IMU slab, sample by sample: the RK4 mean and the closed-form
    covariance transition (module docstring)."""
    dtp = s["P"].dtype
    g = np.array([0.0, 0.0, -f["gravity"]], dtp)
    Qc = np.diag(np.repeat(np.array(
        [f["gyro_noise"], f["acc_noise"], f["gyro_bias_noise"],
         f["acc_bias_noise"]], dtp) ** 2, 3))
    I3 = np.eye(3, dtype=dtp)
    P = s["P"]
    for k in np.nonzero(fr["imu_mask"])[0]:
        dt = fr["imu_t"][k] - s["t"]
        w = fr["gyro"][k] - s["bg"]
        a = fr["acc"][k] - s["ba"]
        w_old = s["last_gyro"] - s["bg"]
        R0, v0, p0 = s["R"], s["v"], s["p"]
        R1 = R0 @ m.exp(w * dt)
        Rm = R0 @ m.exp(0.5 * w * dt)
        k1, k2, k4 = R0 @ a + g, Rm @ a + g, R1 @ a + g
        v1 = v0 + dt / 6 * (k1 + 4 * k2 + k4)
        p1 = p0 + v0 * dt + dt * dt / 6 * (k1 + 2 * k2)
        Phi = phi_closed_form(R0, dt, w, w_old, v0, p0, v1, p1, g)
        G = np.zeros((LEG, 12), dtp)
        G[0:3, 0:3], G[3:6, 3:6] = -R0, -R0
        G[9:12, 6:9], G[12:15, 9:12] = I3, I3
        PhiG = Phi @ G
        P[:LEG, :] = Phi @ P[:LEG, :]
        P[:, :LEG] = P[:, :LEG] @ Phi.T
        P[:LEG, :LEG] += PhiG @ Qc @ PhiG.T * dt
        s["R"], s["v"], s["p"], s["t"] = R1, v1, p1, fr["imu_t"][k]
        s["last_gyro"], s["last_acc"] = fr["gyro"][k], fr["acc"][k]
    s["P"] = 0.5 * (P + P.T)


# --- the update and its increment ---

def update(f: dict, s: dict, rows: list):
    """The stacked EKF update of rows [(H, r)]: K = P H^T (H P H^T +
    sigma^2 I)^-1, the mean moved by dx = K r (incrementState_IMUCam,
    orcvio.cpp:4468: left, clones and in-state rho alike; no move where
    |dv| > 1 or |dp| > 1.5), P <- sym(P - K H P). Returns dx."""
    D = len(s["P"])
    if not rows:
        return np.zeros(D, s["P"].dtype)
    H = np.concatenate([h for h, _ in rows])
    r = np.concatenate([x for _, x in rows])
    P = s["P"]
    HP = H @ P
    S = HP @ H.T + f["observation_noise"] ** 2 * np.eye(len(r), dtype=P.dtype)
    K = np.linalg.solve(S, HP).T
    dx = K @ r
    if not (np.linalg.norm(dx[3:6]) > 1.0 or np.linalg.norm(dx[6:9]) > 1.5):
        s["R"] = m.exp(dx[0:3]) @ s["R"]
        s["v"], s["p"] = s["v"] + dx[3:6], s["p"] + dx[6:9]
        s["bg"], s["ba"] = s["bg"] + dx[9:12], s["ba"] + dx[12:15]
        for c in np.nonzero(s["cvalid"])[0]:
            d = dx[LEG + 6 * c: LEG + 6 * c + 6]
            s["cR"][c] = m.exp(d[0:3]) @ s["cR"][c]
            s["cp"][c] = s["cp"][c] + d[3:6]
        for i in np.nonzero(s["in_state"])[0]:
            s["idp"][i, 2] += dx[base(f) + s["state_slot"][i]]
    A = P - K @ HP
    s["P"] = 0.5 * (A + A.T)
    return dx


def base(f: dict) -> int:
    """The first error-state column of the feature blocks."""
    return LEG + 6 * f["sw_size"]


# --- ZUPT ---

def _two_newest(s: dict, slots):
    return sorted(slots, key=lambda c: s["corder"][c])[-2:]


def zupt_feat(f: dict, s: dict) -> bool:
    """Static scene from the features' motion (checkZUPTFeat)."""
    d = []
    for i in np.nonzero(s["active"] & (s["uv_valid"].sum(1) >= 2))[0]:
        a, b = _two_newest(s, np.nonzero(s["uv_valid"][i])[0])
        d.append(np.linalg.norm(s["uv"][i, b] - s["uv"][i, a]))
    if len(d) < 20:
        return False
    d = sorted(d, reverse=True)
    return len(d) > 8 and d[8] < f["zupt_max_feature_dis"]


def zupt_imu(f: dict, s: dict, fr: dict) -> bool:
    """Static body from the slab's specific force (checkZUPTIMU)."""
    dtp = s["P"].dtype
    t, mask = fr["imu_t"], fr["imu_mask"]
    R = s["R"]
    g = np.array([0.0, 0.0, -f["gravity"]], dtp)
    rows, rs, noise = [], [], []
    for k in range(1, len(t)):
        if not (mask[k] and mask[k - 1]):
            continue
        dt = t[k] - t[k - 1]
        dt = dt if dt > 1e-6 else 1e-2
        a = fr["acc"][k] - s["ba"]
        H = np.zeros((6, 9), dtp)
        H[0:3, 3:6] = np.eye(3)
        H[3:6, 0:3] = (m.hat(R @ a) if f["use_left_perturbation"]
                       else R @ m.hat(a))
        H[3:6, 6:9] = R
        rows.append(H)
        rs.append(np.concatenate([np.zeros(3, dtp), -(R @ a + g)]))
        noise += [SIGMA_W2 / dt] * 3 + [SIGMA_A2 / dt] * 3
    n = len(rows)
    if n < 2:
        return False
    span = sum(t[k] - t[k - 1] if t[k] - t[k - 1] > 1e-6 else 1e-2
               for k in range(1, len(t)) if mask[k] and mask[k - 1])
    J = np.r_[0:3, 9:15]
    Pm = s["P"][np.ix_(J, J)] + np.diag(np.concatenate(
        [np.zeros(3), np.full(3, span * SIGMA_WB), np.full(3, span * SIGMA_AB)]
    )).astype(dtp)
    H, r = np.concatenate(rows), np.concatenate(rs)
    S = H @ Pm @ H.T + np.diag(np.array(noise, dtp))
    gamma = r @ np.linalg.solve(S, r)
    return bool(gamma < chi2.ppf(f["chi2_confidence"], 3 * n)
                and np.linalg.norm(s["v"]) < ZUPT_MAX_V)


def quat(R) -> np.ndarray:
    """R's unit quaternion [x, y, z, w] (Hamilton) with w >= 0, by the
    largest of its four pivots (Shepperd)."""
    tr = np.trace(R)
    k = int(np.argmax([R[0, 0], R[1, 1], R[2, 2], tr]))
    if k == 3:
        w = 0.5 * math.sqrt(1.0 + tr)
        q = [(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
             (R[1, 0] - R[0, 1]) / (4 * w), w]
    else:
        i, j, l = k, (k + 1) % 3, (k + 2) % 3
        e = 0.5 * math.sqrt(max(1.0 + 2.0 * R[i, i] - tr, 1e-12))
        q = [0.0] * 4
        q[i] = e
        q[j] = (R[i, j] + R[j, i]) / (4 * e)
        q[l] = (R[i, l] + R[l, i]) / (4 * e)
        q[3] = (R[l, j] - R[j, l]) / (4 * e)
    q = np.array(q, R.dtype)
    q = -q if q[3] < 0 else q
    return q / np.linalg.norm(q)


def quat_vec(q1, q2) -> np.ndarray:
    """The vector part of the unit q1 q2^-1 (Hamilton)."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = -q2[0], -q2[1], -q2[2], q2[3]
    q = np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                  w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                  w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], q1.dtype)
    return (q / np.linalg.norm(q))[:3]


def zupt_update(f: dict, s: dict) -> None:
    """v ~ 0, p_cur - p_prev ~ 0, q_cur q_prev^-1 ~ 1 on the two newest
    clones (measurementUpdate_ZUPT_vpq), with the ZUPT noises."""
    valid = np.nonzero(s["cvalid"])[0]
    if len(valid) < 2:
        return
    prev, cur = _two_newest(s, valid)
    D = len(s["P"])
    H = np.zeros((9, D), s["P"].dtype)
    cc, cp = LEG + 6 * cur, LEG + 6 * prev
    H[0:3, 3:6] = np.eye(3)
    H[3:6, cc + 3:cc + 6], H[3:6, cp + 3:cp + 6] = np.eye(3), -np.eye(3)
    H[6:9, cc:cc + 3], H[6:9, cp:cp + 3] = -0.5 * np.eye(3), 0.5 * np.eye(3)
    r = np.concatenate([-s["v"], -(s["cp"][cur] - s["cp"][prev]),
                        quat_vec(quat(s["cR"][cur]), quat(s["cR"][prev]))])
    # the rows scaled so that the shared sigma^2 I noise is the ZUPT's
    w = np.repeat([f["observation_noise"] / math.sqrt(n) for n in ZUPT_NOISE],
                  3).astype(H.dtype)
    update(f, s, [(H * w[:, None], r * w)])


# --- in-state features ---

def cam(cfg: dict, s: dict, c: int):
    """Clone slot c's camera (R_c2w, t_c_w)."""
    Rc, tc = m.cam_poses(cfg, s)
    return Rc[c], tc[c]


def world_point(cfg: dict, s: dict, i: int):
    """In-state feature i's world position from its anchor camera."""
    x = s["idp"][i]
    rho = x[2] if abs(x[2]) > 1e-8 else 1e-8
    Ra, ta = cam(cfg, s, s["anchor_slot"][i])
    return Ra @ (np.array([x[0], x[1], 1.0], x.dtype) / rho) + ta


def d_point_d_rho(x):
    """d p_anchor / d rho of p = (alpha, beta, 1) / rho."""
    rho = x[2] if abs(x[2]) > 1e-8 else 1e-8
    return -np.array([x[0], x[1], 1.0], x.dtype) / rho ** 2


def feature_row(cfg: dict, s: dict, i: int, cur: int):
    """Tracked in-state feature i's two rows against the current clone,
    its anchor clone and its rho (measurementJacobian_ekf_1didp)."""
    f = cfg["filter"]
    D = len(s["P"])
    Rk, tk = cam(cfg, s, cur)
    Ra, _ = cam(cfg, s, s["anchor_slot"][i])
    p_w = world_point(cfg, s, i)
    pc = Rk.T @ (p_w - tk)
    z = pc[2] if abs(pc[2]) > 1e-6 else 1e-6
    dz = np.array([[1 / z, 0, -pc[0] / z ** 2], [0, 1 / z, -pc[1] / z ** 2]],
                  pc.dtype)
    H = np.zeros((2, D), pc.dtype)
    a = s["anchor_slot"][i]
    ca, ck = LEG + 6 * a, LEG + 6 * cur
    H[:, ca:ca + 3] = dz @ (-Rk.T @ m.hat(p_w - s["cp"][a]))
    H[:, ca + 3:ca + 6] = dz @ Rk.T
    H[:, ck:ck + 3] += dz @ Rk.T @ m.hat(p_w - s["cp"][cur])
    H[:, ck + 3:ck + 6] += -dz @ Rk.T
    H[:, base(f) + s["state_slot"][i]] = dz @ Rk.T @ Ra @ d_point_d_rho(
        s["idp"][i])
    r = s["uv"][i, cur] - np.array([pc[0] / z, pc[1] / z])
    return H, r.astype(pc.dtype)


def raw_rows(cfg: dict, s: dict, i: int, track: list, p_w):
    """Feature i's unprojected rows over `track`: (H_x (2n, D), H_f (2n,
    3), r (2n,)), the clone blocks of ``msckf.feature_rows``."""
    Rc, tc = m.cam_poses(cfg, s)
    D = len(s["P"])
    n = len(track)
    Hx = np.zeros((2 * n, D), p_w.dtype)
    Hf = np.zeros((2 * n, 3), p_w.dtype)
    r = np.zeros(2 * n, p_w.dtype)
    for k, c in enumerate(track):
        Rw2c = Rc[c].T
        pc = Rw2c @ (p_w - tc[c])
        dz = np.array([[1 / pc[2], 0, -pc[0] / pc[2] ** 2],
                       [0, 1 / pc[2], -pc[1] / pc[2] ** 2]], pc.dtype)
        rw = slice(2 * k, 2 * k + 2)
        r[rw] = s["uv"][i, c] - pc[:2] / pc[2]
        col = LEG + 6 * c
        Hx[rw, col:col + 3] = dz @ Rw2c @ m.hat(p_w - s["cp"][c])
        Hx[rw, col + 3:col + 6] = -dz @ Rw2c
        Hf[rw] = dz @ Rw2c
    return Hx, Hf, r


class Join:
    """A track joining the state: its anchor slot, inverse depth (alpha,
    beta, rho) there, and its rho-bearing row (H1, H2, r1)."""

    def __init__(self, i, a, x, h, H1, H2, r1):
        self.i, self.a, self.x = i, a, x
        self.h, self.H1, self.H2, self.r1 = h, H1, H2, r1


def split_rho(cfg, s, i, track, a, p_w):
    """(Join, the rows free of rho (H, r)) of track i anchored at slot a."""
    Ra, ta = cam(cfg, s, a)
    q = Ra.T @ (p_w - ta)
    x = np.array([q[0] / q[2], q[1] / q[2], 1.0 / q[2]], p_w.dtype)
    Hx, Hf, r = raw_rows(cfg, s, i, track, p_w)
    h = Hf @ (Ra @ d_point_d_rho(x))  # (2n,): the rho column
    beta = -math.copysign(np.linalg.norm(h), h[0])
    N = np.linalg.qr(h[:, None], mode="complete")[0][:, 1:]
    return Join(i, a, x, h, h @ Hx / beta, beta, h @ r / beta), (N.T @ Hx,
                                                                 N.T @ r)


def join(f: dict, s: dict, j: Join, dx) -> None:
    """Track j.i into the lowest free feature slot, from the post-update
    P and the update's dx (measurementUpdate_hybrid :1824-1920)."""
    E = f["ekf_feature_cap"]
    used = {int(s["state_slot"][i]) for i in np.nonzero(s["in_state"])[0]}
    slot = min(set(range(E)) - used)
    H2 = j.H2 + 1e-10
    HH = j.H1 / H2
    rho_step = (j.r1 - j.H1 @ dx) / H2
    P = s["P"]
    P21 = -HH @ P
    P22 = -P21 @ HH + f["observation_noise"] ** 2 / H2 ** 2
    c = base(f) + slot
    P[c, :], P[:, c] = P21, P21
    P[c, c] = P22
    s["P"] = 0.5 * (P + P.T)
    i = j.i
    s["idp"][i] = j.x + np.array([0.0, 0.0, rho_step], j.x.dtype)
    s["anchor_slot"][i], s["state_slot"][i] = j.a, slot
    s["in_state"][i] = True


def remove(f: dict, s: dict, rows) -> None:
    """Drop in-state features: their covariance rows and columns zeroed
    (rmLostFeaturesCov), their table rows freed."""
    for i in np.nonzero(rows & s["in_state"])[0]:
        c = base(f) + s["state_slot"][i]
        s["P"][c, :] = 0.0
        s["P"][:, c] = 0.0
    free(s, rows)


def free(s: dict, rows) -> None:
    """Free table rows (map_server.erase)."""
    m.erase(s, rows)
    s["in_state"] = s["in_state"] & ~rows
    s["state_slot"] = np.where(rows, -1, s["state_slot"])
    s["anchor_slot"] = np.where(rows, -1, s["anchor_slot"])


def reanchor(cfg: dict, s: dict, prune, cur: int) -> None:
    """In-state features anchored at a pruned clone move to the current
    clone: rho in the new camera and P <- T P T^T, T the identity but for
    each moved feature's row, the derivative of its new rho with respect
    to [rho, old anchor (theta, p), new anchor (theta, p), extrinsics]
    (left perturbations; R_b2c <- R_b2c exp(-dtheta_e))."""
    f = cfg["filter"]
    dtp = s["P"].dtype
    need = [i for i in np.nonzero(s["in_state"])[0]
            if prune[s["anchor_slot"][i]] and s["anchor_slot"][i] != cur]
    if not need:
        return
    tdt = torch.float64 if dtp == np.float64 else torch.float32
    T_ = lambda x: torch.as_tensor(np.asarray(x), dtype=tdt)  # noqa: E731
    Rbc, tcb = T_(s["R_b2c"]), T_(s["t_c_b"])
    Rk, pk = T_(s["cR"][cur]), T_(s["cp"][cur])

    def hat(w):
        z = torch.zeros((), dtype=tdt)
        return torch.stack([torch.stack([z, -w[2], w[1]]),
                            torch.stack([w[2], z, -w[0]]),
                            torch.stack([-w[1], w[0], z])])

    def expm(w):
        return torch.linalg.matrix_exp(hat(w))

    D = len(s["P"])
    T = np.eye(D, dtype=dtp)
    moved = {}
    for i in need:
        a = s["anchor_slot"][i]
        x0, Ra, pa = T_(s["idp"][i]), T_(s["cR"][a]), T_(s["cp"][a])

        def new_x(d):
            rho = x0[2] + d[0]
            rho = rho if abs(float(rho.detach())) > 1e-8 else rho * 0 + 1e-8
            Rb = Rbc @ expm(-d[13:16])
            tb = tcb + d[16:19]
            p_ca = torch.stack([x0[0] / rho, x0[1] / rho, 1.0 / rho])
            p_w = expm(d[1:4]) @ Ra @ (Rb.T @ p_ca + tb) + pa + d[4:7]
            p_ck = Rb @ ((expm(d[7:10]) @ Rk).T @ (p_w - pk - d[10:13]) - tb)
            return torch.stack([p_ck[0] / p_ck[2], p_ck[1] / p_ck[2],
                                1.0 / p_ck[2]]), p_ck[2]

        zero = torch.zeros(19, dtype=tdt)
        x1, depth = new_x(zero)
        J = torch.autograd.functional.jacobian(lambda d: new_x(d)[0][2], zero)
        x1, J = x1.detach().numpy(), J.numpy()
        if not (float(depth) > 1e-3 and np.isfinite(x1).all()
                and np.isfinite(J).all()):
            continue
        row = np.zeros(D, dtp)
        row[base(f) + s["state_slot"][i]] = J[0]
        row[LEG + 6 * a: LEG + 6 * a + 6] = J[1:7]
        row[LEG + 6 * cur: LEG + 6 * cur + 6] += J[7:13]
        row[15:21] = J[13:19]
        T[base(f) + s["state_slot"][i]] = row
        moved[i] = x1
    P = T @ s["P"] @ T.T
    s["P"] = 0.5 * (P + P.T)
    for i, x1 in moved.items():
        s["idp"][i], s["anchor_slot"][i] = x1, cur


# --- the frame ---

def step(cfg: dict, state: dict, frame: dict, dtype=np.float64) -> dict:
    """The state after one frame (processFeatures, orcvio.cpp:500): the
    IMU slab, a new clone, the measurements, ZUPT, the removal of lost
    in-state features, the hybrid update and the joins, the prune of two
    clones once the window is full (the last-chance update, the anchor
    changes, the removal of features whose anchor is gone). state and
    frame are dicts of arrays (``STATE_KEYS``; frame: imu_t, gyro, acc,
    imu_mask, fids, uvs, meas_mask); the result's floats are in dtype."""
    f = cfg["filter"]
    check_flags(f)
    s, fr = _cast(state, dtype), _cast(frame, dtype)
    propagate(f, s, fr)
    cur = m.augment(s)
    rate = m.ingest(s, cur, fr)
    zupt = zupt_feat(f, s) or zupt_imu(f, s, fr)
    if zupt:
        zupt_update(f, s)
    anchor_ok = np.array([a >= 0 and s["cvalid"][a] for a in s["anchor_slot"]])
    remove(f, s, s["in_state"] & (~s["active"] | ~anchor_ok))

    cams = m.cam_poses(cfg, s)
    T, E = f["max_track_len"], f["ekf_feature_cap"]
    Kc = min(f["max_update_features"], len(s["fid"]))
    live = s["fid"] >= 0
    n = s["uv_valid"].sum(axis=1)
    lost = live & ~s["active"] & ~s["in_state"]
    too_long = live & s["active"] & (n >= T) & ~s["in_state"]
    finished = lost | too_long
    cand = np.nonzero(finished & (n >= f["min_track_len"]))[0][:Kc]
    rows, joins = [], []
    room = min(E - int(s["in_state"].sum()), JOIN_MAX)
    for i in cand:
        track = m.obs(s, i, T)
        tri = [o for o in track if not (s["active"][i] and o == cur)]
        p_w = m.triangulate(f, s, i, tri, cams)
        if p_w is None or len(track) < 2:
            continue
        H, r = m.feature_rows(s, i, track, p_w, cams)
        if not m.gate(f, s["P"], H, r):
            continue
        if too_long[i] and len(joins) < room:
            j, rho_free = split_rho(cfg, s, i, track, tri[-1], p_w)
            joins.append(j)
            rows.append(rho_free)
        else:
            rows.append((H, r))
    for i in np.nonzero(s["in_state"] & s["active"] & s["uv_valid"][:, cur])[0]:
        if s["cvalid"][s["anchor_slot"][i]] and s["anchor_slot"][i] != cur:
            rows.append(feature_row(cfg, s, i, cur))
    dx = update(f, s, rows)
    for j in joins:
        join(f, s, j, dx)
    joined = np.zeros(len(s["fid"]), bool)
    joined[[j.i for j in joins]] = True
    free(s, finished & ~joined)

    prune = m.prune_slots(f, s, rate, m.cam_poses(cfg, s))
    if prune.any() and not zupt:
        last_chance(cfg, s, prune)
    if prune.any():
        reanchor(cfg, s, prune, cur)
        gone = np.array([bool(s["in_state"][i] and prune[s["anchor_slot"][i]])
                         for i in range(len(s["fid"]))])
        remove(f, s, gone)
        m.drop(s, prune)
    return s


def last_chance(cfg: dict, s: dict, prune) -> None:
    """The update on the observations that die with the pruned clones
    (orcvio.cpp:2803-2851): each live track outside the state with two or
    more of them, its position from its whole track, its rows from those
    observations."""
    f = cfg["filter"]
    T = f["max_track_len"]
    cams = m.cam_poses(cfg, s)
    Kc = min(f["max_update_features"], len(s["fid"]))
    cand = [i for i in np.nonzero((s["fid"] >= 0) & ~s["in_state"])[0]
            if len(m.obs(s, i, T, prune)) >= 2][:Kc]
    rows = []
    for i in cand:
        p_w = m.triangulate(f, s, i, m.obs(s, i, T), cams)
        if p_w is None:
            continue
        H, r = m.feature_rows(s, i, m.obs(s, i, T, prune), p_w, cams)
        if m.gate(f, s["P"], H, r):
            rows.append((H, r))
    update(f, s, rows)


def static_init(cfg: dict, imu: list, dtype=np.float64) -> dict:
    """The state static initialization starts the filter from, given the
    IMU slabs of every frame up to the one it ends on: R, v, p, bg, ba and
    P (StaticInitializer.cpp:77-135 and the initial covariance, orcvio.cpp:
    201-222)."""
    f = cfg["filter"]
    g = np.zeros(3, dtype)
    a = np.zeros(3, dtype)
    n = 0
    for fr in imu:
        mk = np.asarray(fr["imu_mask"])
        g = g + np.asarray(fr["gyro"], dtype)[mk].sum(0)
        a = a + np.asarray(fr["acc"], dtype)[mk].sum(0)
        n += int(mk.sum())
    bg, acc = g / max(n, 1), a / max(n, 1)
    u = acc / max(np.linalg.norm(acc), 1e-9)
    axis = np.cross(u, np.array([0.0, 0.0, 1.0], dtype))
    s = np.linalg.norm(axis)
    ang = math.atan2(s, u[2])
    axis = axis / s if s > 1e-9 else np.array([1.0, 0.0, 0.0], dtype)
    D = LEG + 6 * f["sw_size"] + f["ekf_feature_cap"]
    d = np.zeros(D, dtype)
    for sl, key in ((slice(0, 3), "init_cov_orientation"),
                    (slice(3, 6), "init_cov_velocity"),
                    (slice(6, 9), "init_cov_position"),
                    (slice(9, 12), "init_cov_gyro_bias"),
                    (slice(12, 15), "init_cov_acc_bias")):
        d[sl] = f[key]
    z3 = np.zeros(3, dtype)
    return {"R": m.exp((axis * ang).astype(dtype)), "v": z3, "p": z3,
            "bg": bg.astype(dtype), "ba": z3, "P": np.diag(d)}
