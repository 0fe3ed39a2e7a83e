"""The plain reference of the back-end cells: one frame of OrcVIO's MSCKF
in NumPy, written from the estimator's equations (Shan et al.,
arXiv:2007.15107, section IV; the upstream orcvio.cpp:
processFeatures, batchImuProcessing, stateAugmentation,
measurementUpdate_msckf, findRedundantImuStates, pruneImuStateBuffer),
one feature and one IMU sample at a time. It imports nothing of the port.

It follows the program one frame at a time from the program's own state,
handed over as a dict of arrays (``STATE_KEYS``): the IMU mean, the clone
window, the feature table (each row's observations by clone slot) and P.
It covers the flags of the configuration it is given, and refuses others:
the SE_2(3) closed-form mean with left perturbation (R <- exp(dtheta) R,
p <- p + dp), first-order covariance transition, pure MSCKF (no feature in
the state), no FEJ, extrinsics and time offset fixed, no ZUPT, no parallax
check before triangulation, the stacked update in full ("direct"), the
last-chance update on pruned clones.

Error state: [0:3] theta, [3:6] v, [6:9] p, [9:12] bg, [12:15] ba,
[15:22] extrinsics and td (fixed: zero covariance), then 6 a clone slot,
[theta, p].

``dtype`` sets the precision every float is computed in: float64 is the
reference, float32 the control one step below.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.stats import chi2

LEG = 22
STATE_KEYS = ("t", "R", "v", "p", "bg", "ba", "last_gyro", "last_acc",
              "cR", "cp", "ct", "corder", "cvalid", "uv", "uv_valid", "fid",
              "active", "P", "next_order")
# findRedundantImuStates's thresholds (orcvio.cpp:2582)
PRUNE_ROTATION = 0.2618
PRUNE_TRANSLATION = 0.4
PRUNE_TRACKING_RATE = 0.5
# Feature::triangulate_position's cost threshold (feature.hpp:58)
TRI_COST = 4.7673e-4

_FLAGS = {"use_larvio": False, "use_left_perturbation": True,
          "use_closed_form_cov_prop": False, "if_fej": False,
          "estimate_extrinsic": False, "estimate_td": False,
          "if_zupt": False, "use_schmidt": False, "calib_imu": False,
          "prediction_only": False, "update_form": "direct",
          "joseph_form": False, "prune_last_chance": True,
          "ekf_feature_cap": 0}


def check_flags(f: dict) -> None:
    """Raise where the configuration asks for a path this reference does
    not compute."""
    wrong = {k: f.get(k) for k, v in _FLAGS.items() if f.get(k) != v}
    if f.get("tri_translation_threshold", 0.0) >= 0:  # checkMotion on
        wrong["tri_translation_threshold"] = f.get("tri_translation_threshold")
    if wrong:
        raise ValueError(f"the MSCKF reference covers {_FLAGS}; got {wrong}")


# --- SO(3) ---

def hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                     [-w[1], w[0], 0.0]], dtype=w.dtype)


def _series(w, k: int):
    """sum_n hat(w)^n / (n + k)!: exp (k = 0), the left Jacobian (1), the
    position operator (2), summed term by term (30 terms leave under
    1e-17 for |w| <= pi; every angle here is a sample's or an update's)."""
    W = hat(w)
    out = np.zeros((3, 3), w.dtype)
    term = np.eye(3, dtype=w.dtype) / math.factorial(k)
    for n in range(30):
        out = out + term
        term = term @ W / (n + k + 1)
    return out


def exp(w):
    return _series(w, 0)


def angle(R) -> float:
    """The rotation angle of R, from its skew part and its trace."""
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                              R[1, 0] - R[0, 1]])
    return math.atan2(s, 0.5 * (np.trace(R) - 1.0))


# --- the frame ---

def step(cfg: dict, state: dict, frame: dict, dtype=np.float64) -> dict:
    """The state after one frame (processFeatures, orcvio.cpp:500): the
    IMU slab, a new clone, the measurements, the update on the finished
    tracks, the prune of two clones when the window is full with the
    last-chance update on their observations. state and frame are dicts
    of arrays; the result's floats are in dtype."""
    f = cfg["filter"]
    check_flags(f)
    s = {k: (np.array(v, dtype) if np.asarray(v).dtype.kind == "f"
             else np.array(v)) for k, v in state.items()}
    fr = {k: (np.array(v, dtype) if np.asarray(v).dtype.kind == "f"
              else np.array(v)) for k, v in frame.items()}
    propagate(f, s, fr)
    cur = augment(s)
    rate = ingest(s, cur, fr)
    cams = cam_poses(cfg, s)
    T, Kc = f["max_track_len"], min(f["max_update_features"],
                                    len(s["fid"]))
    live = s["fid"] >= 0
    n = s["uv_valid"].sum(axis=1)
    lost = live & ~s["active"]
    too_long = live & s["active"] & (n >= T)
    finished = lost | too_long
    cand = np.nonzero(finished & (n >= f["min_track_len"]))[0][:Kc]
    rows = []
    for i in cand:
        track = obs(s, i, T)
        tri = [o for o in track if not (s["active"][i] and o == cur)]
        p_w = triangulate(f, s, i, tri, cams)
        if p_w is None or len(track) < 2:
            continue
        H, r = feature_rows(s, i, track, p_w, cams)
        if gate(f, s["P"], H, r):
            rows.append((H, r))
    update(f, s, rows)
    erase(s, finished)
    prune = prune_slots(f, s, rate, cam_poses(cfg, s))
    if prune.any():
        last_chance(cfg, s, prune)
        drop(s, prune)
    return s


def propagate(f: dict, s: dict, fr: dict) -> None:
    """The IMU slab, sample by sample (batchImuProcessing, orcvio.cpp:664;
    predictNewStateOrcVIO :899; calPhiEulerMethod :3952): the SE_2(3)
    closed-form mean over each constant sample,
        R' = R exp(w dt), v' = v + g dt + R Jl(w dt) a dt,
        p' = p + v dt + g dt^2 / 2 + R Hl(w dt) a dt^2,
    and P's IMU leg P <- Phi P Phi^T + Phi G Qc G^T Phi^T dt with the
    first-order Phi at the new attitude (left perturbation)."""
    dt_ = s["P"].dtype
    g = np.array([0.0, 0.0, -f["gravity"]], dt_)
    Qc = np.diag(np.repeat(np.array(
        [f["gyro_noise"], f["acc_noise"], f["gyro_bias_noise"],
         f["acc_bias_noise"]], dt_) ** 2, 3))
    I3 = np.eye(3, dtype=dt_)
    P = s["P"]
    for k in np.nonzero(fr["imu_mask"])[0]:
        dt = fr["imu_t"][k] - s["t"]
        w = fr["gyro"][k] - s["bg"]
        a = fr["acc"][k] - s["ba"]
        R0 = s["R"]
        R1 = R0 @ exp(w * dt)
        s["p"] = (s["p"] + s["v"] * dt + g * dt * dt / 2
                  + R0 @ _series(w * dt, 2) @ a * dt * dt)
        s["v"] = s["v"] + g * dt + R0 @ _series(w * dt, 1) @ a * dt
        s["R"], s["t"] = R1, fr["imu_t"][k]
        Phi = np.eye(LEG, dtype=dt_)
        Phi[0:3, 9:12] = -dt * R1
        Phi[3:6, 0:3] = -dt * hat(R1 @ a)
        Phi[3:6, 12:15] = -dt * R1
        Phi[6:9, 3:6] = dt * I3
        G = np.zeros((LEG, 12), dt_)
        G[0:3, 0:3] = -R0
        G[3:6, 3:6] = -R0
        G[9:12, 6:9] = I3
        G[12:15, 9:12] = I3
        PhiG = Phi @ G
        P[:LEG, :] = Phi @ P[:LEG, :]
        P[:, :LEG] = P[:, :LEG] @ Phi.T
        P[:LEG, :LEG] += PhiG @ Qc @ PhiG.T * dt
        s["last_gyro"], s["last_acc"] = fr["gyro"][k], fr["acc"][k]
    s["P"] = 0.5 * (P + P.T)


def augment(s: dict) -> int:
    """The IMU pose as a clone in the first free slot (stateAugmentation,
    orcvio.cpp:930): its rows and columns of P those of [theta, p]."""
    free = np.nonzero(~s["cvalid"])[0]
    c = int(free[0]) if len(free) else 0
    P = s["P"]
    cols = slice(LEG + 6 * c, LEG + 6 * c + 6)
    P[cols, :] = 0.0
    P[:, cols] = 0.0
    J = np.r_[0:3, 6:9]
    P[cols, :] = P[J, :]
    P[:, cols] = P[:, J]
    s["P"] = 0.5 * (P + P.T)
    s["cR"][c], s["cp"][c], s["ct"][c] = s["R"], s["p"], s["t"]
    s["corder"][c], s["cvalid"][c] = s["next_order"], True
    s["next_order"] = s["next_order"] + 1
    return c


def ingest(s: dict, cur: int, fr: dict) -> float:
    """The frame's measurements into the table at clone slot cur
    (addFeatureObservations, orcvio.cpp:1016): a known id extends its row,
    a new id takes the first free row while there is one; a row that gets
    no measurement is inactive. Returns the share of the rows active
    before that were tracked."""
    before = int(s["active"].sum())
    row_of = {int(fid): i for i, fid in enumerate(s["fid"]) if fid >= 0}
    free = [i for i, fid in enumerate(s["fid"]) if fid < 0]
    got = np.zeros(len(s["fid"]), bool)
    tracked = 0
    for m in np.nonzero(fr["meas_mask"] & (fr["fids"] >= 0))[0]:
        fid = int(fr["fids"][m])
        if fid in row_of:
            i = row_of[fid]
            tracked += 1
        elif free:
            i = free.pop(0)
            s["fid"][i] = fid
        else:
            continue
        s["uv"][i, cur] = fr["uvs"][m]
        s["uv_valid"][i, cur] = True
        got[i] = True
    s["active"] = got & (s["fid"] >= 0)
    return tracked / max(before, 1)


def cam_poses(cfg: dict, s: dict):
    """Each clone slot's camera (R_c2w, t_c_w) from the fixed extrinsics."""
    ext = cfg["extrinsics"]
    R_b2c = np.array(ext["R_b2c"], s["P"].dtype)
    t_c_b = np.array(ext["t_c_b"], s["P"].dtype)
    return s["cR"] @ R_b2c.T, s["cp"] + s["cR"] @ t_c_b


def obs(s: dict, i: int, T: int, slots=None) -> list:
    """Row i's observed clone slots, oldest first, at most T (of `slots`
    alone where given)."""
    have = [c for c in np.nonzero(s["uv_valid"][i])[0]
            if slots is None or slots[c]]
    return sorted(have, key=lambda c: s["corder"][c])[:T]


def triangulate(f: dict, s: dict, i: int, track: list, cams):
    """Row i's world position from the observations of `track`, or None
    where it fails (Feature::triangulate_position, feature.hpp:583): the
    unknowns x = (alpha, beta, rho) = (X/Z, Y/Z, 1/Z) in the newest
    camera; the two-view guess of the first and the newest; Levenberg-
    Marquardt with Huber weights, tri_max_iters steps; then the checks:
    positive depth in every camera, the normalized cost, and the
    distance from the guess."""
    n = len(track)
    if n < 2:
        return None
    Rc, tc = cams
    a = track[-1]
    Ra, ta = Rc[a], tc[a]
    Rr = [Rc[c].T @ Ra for c in track]  # anchor -> camera c
    tr = [Rc[c].T @ (ta - tc[c]) for c in track]
    z = [s["uv"][i, c] for c in track]
    one = np.ones(1, s["P"].dtype)
    m = Rr[0] @ np.concatenate([z[-1], one])
    A = np.array([m[0] - z[0][0] * m[2], m[1] - z[0][1] * m[2]])
    b = np.array([z[0][0] * tr[0][2] - tr[0][0],
                  z[0][1] * tr[0][2] - tr[0][1]])
    den = A @ A
    depth = (A @ b) / den if den > 1e-12 else 1.0
    depth = min(max(depth, 0.1), 1e3)
    x0 = np.array([z[-1][0], z[-1][1], 1.0 / depth], s["P"].dtype)

    def residuals(x):
        h = [R @ np.array([x[0], x[1], 1.0], x.dtype) + x[2] * t
             for R, t in zip(Rr, tr)]
        return h, [hk[:2] / hk[2] - zk for hk, zk in zip(h, z)]

    x, lam = x0, f["tri_initial_damping"]
    h, r = residuals(x)
    cost = sum(rk @ rk for rk in r)
    for _ in range(f["tri_max_iters"]):
        Ah = lam * np.eye(3, dtype=x.dtype)
        bh = np.zeros(3, x.dtype)
        for hk, rk, R, t in zip(h, r, Rr, tr):
            W = np.column_stack([R[:, 0], R[:, 1], t])  # dh/dx
            J = W[:2] / hk[2] - np.outer(hk[:2], W[2]) / hk[2] ** 2
            e = np.linalg.norm(rk)
            wk = 1.0 if e <= f["huber_epsilon"] else \
                2.0 * f["huber_epsilon"] / max(e, 1e-12)
            Ah += wk * J.T @ J
            bh += wk * J.T @ rk
        xn = x - np.linalg.solve(Ah, bh)
        hn, rn = residuals(xn)
        cn = sum(rk @ rk for rk in rn)
        if cn < cost:
            x, h, r, cost = xn, hn, rn, cn
            lam = max(lam / 10, 1e-10)
        else:
            lam = min(lam * 10, 1e12)
    rho = x[2] if abs(x[2]) > 1e-8 else 1e-8
    p_a = np.array([x[0], x[1], 1.0], x.dtype) / rho
    ok = (x[2] > 0 and all(hk[2] / rho > 0 for hk in h)
          and cost / max(2.0 * n * n, 1.0) < TRI_COST
          and np.linalg.norm(p_a - np.array([x0[0], x0[1], 1.0], x.dtype)
                             / x0[2])
          < 5.0)
    return (Ra @ p_a + ta).astype(x.dtype) if ok else None


def feature_rows(s: dict, i: int, track: list, p_w, cams):
    """Row i's measurement rows over `track` with its position projected
    out (measurementJacobian_msckf and featureJacobian_msckf, orcvio.cpp:
    1071-1230): each observation's residual z - pi(p_c) and Jacobians
    d pi / d(theta, p) of its clone, dp_c/dtheta = R_w2c hat(p_w - p_b),
    dp_c/dp = -R_w2c, and d pi / d p_w; the rows then go onto the left
    null space of the stacked d pi / d p_w. Returns (H (2n - 3, D),
    r (2n - 3,))."""
    Rc, tc = cams
    D = s["P"].shape[0]
    n = len(track)
    Hx = np.zeros((2 * n, D), s["P"].dtype)
    Hf = np.zeros((2 * n, 3), s["P"].dtype)
    r = np.zeros(2 * n, s["P"].dtype)
    for k, c in enumerate(track):
        Rw2c = Rc[c].T
        pc = Rw2c @ (p_w - tc[c])
        dz = np.array([[1 / pc[2], 0, -pc[0] / pc[2] ** 2],
                       [0, 1 / pc[2], -pc[1] / pc[2] ** 2]], pc.dtype)
        rows = slice(2 * k, 2 * k + 2)
        r[rows] = s["uv"][i, c] - pc[:2] / pc[2]
        col = LEG + 6 * c
        Hx[rows, col:col + 3] = dz @ Rw2c @ hat(p_w - s["cp"][c])
        Hx[rows, col + 3:col + 6] = -dz @ Rw2c
        Hf[rows] = dz @ Rw2c
    N = np.linalg.qr(Hf, mode="complete")[0][:, 3:]
    return N.T @ Hx, N.T @ r


def gate(f: dict, P, H, r) -> bool:
    """gatingTestFeature (orcvio.cpp:1953): r^T (H P H^T + sigma^2 I)^-1 r
    under the chi-square quantile of its rows' count."""
    S = H @ P @ H.T + f["observation_noise"] ** 2 * np.eye(len(r),
                                                           dtype=P.dtype)
    gamma = r @ np.linalg.solve(S, r)
    return bool(gamma < chi2.ppf(f["chi2_confidence"], len(r)))


def update(f: dict, s: dict, rows: list) -> None:
    """The stacked EKF update of rows [(H, r)] (measurementUpdate_msckf,
    orcvio.cpp:1654): K = P H^T (H P H^T + sigma^2 I)^-1, the state moved
    by dx = K r (incrementState_IMUCam, :4468; no move where |dv| > 1 or
    |dp| > 1.5), P <- sym(P - K H P)."""
    if not rows:
        return
    H = np.concatenate([h for h, _ in rows])
    r = np.concatenate([x for _, x in rows])
    P = s["P"]
    HP = H @ P
    S = HP @ H.T + f["observation_noise"] ** 2 * np.eye(len(r), dtype=P.dtype)
    K = np.linalg.solve(S, HP).T
    dx = K @ r
    if not (np.linalg.norm(dx[3:6]) > 1.0 or np.linalg.norm(dx[6:9]) > 1.5):
        s["R"] = exp(dx[0:3]) @ s["R"]
        s["v"], s["p"] = s["v"] + dx[3:6], s["p"] + dx[6:9]
        s["bg"], s["ba"] = s["bg"] + dx[9:12], s["ba"] + dx[12:15]
        for c in np.nonzero(s["cvalid"])[0]:
            d = dx[LEG + 6 * c: LEG + 6 * c + 6]
            s["cR"][c] = exp(d[0:3]) @ s["cR"][c]
            s["cp"][c] = s["cp"][c] + d[3:6]
    A = P - K @ HP
    s["P"] = 0.5 * (A + A.T)


def erase(s: dict, rows) -> None:
    """Free the rows (map_server.erase)."""
    s["fid"] = np.where(rows, -1, s["fid"])
    s["uv_valid"] = s["uv_valid"] & ~rows[:, None]
    s["active"] = s["active"] & ~rows


def prune_slots(f: dict, s: dict, rate: float, cams):
    """The two clone slots to prune once every slot holds a clone
    (findRedundantImuStates, orcvio.cpp:2582): of the second- and
    third-newest, each close to the fourth-newest in rotation and
    translation while the tracking rate is high; the oldest in the place
    of each that is not."""
    sw = f["sw_size"]
    out = np.zeros(sw, bool)
    if not s["cvalid"].all():
        return out
    rank = sorted(range(sw), key=lambda c: s["corder"][c])
    key, old = rank[sw - 4], rank[:2]
    Rc, tc = cams
    red = [angle(Rc[c].T @ Rc[key]) < PRUNE_ROTATION
           and np.linalg.norm(tc[c] - tc[key]) < PRUNE_TRANSLATION
           and rate > PRUNE_TRACKING_RATE for c in rank[sw - 3: sw - 1]]
    a = rank[sw - 3] if red[0] else old[0]
    b = rank[sw - 2] if red[1] else (old[0] if red[0] else old[1])
    out[[a, b]] = True
    return out


def last_chance(cfg: dict, s: dict, prune) -> None:
    """The update on the observations that die with the pruned clones
    (orcvio.cpp:2803-2851): each live row with two or more of them, its
    position from its whole track, its rows from those observations."""
    f = cfg["filter"]
    T = f["max_track_len"]
    cams = cam_poses(cfg, s)
    Kc = min(f["max_update_features"], len(s["fid"]))
    cand = [i for i in np.nonzero(s["fid"] >= 0)[0]
            if len(obs(s, i, T, prune)) >= 2][:Kc]
    rows = []
    for i in cand:
        p_w = triangulate(f, s, i, obs(s, i, T), cams)
        if p_w is None:
            continue
        H, r = feature_rows(s, i, obs(s, i, T, prune), p_w, cams)
        if gate(f, s["P"], H, r):
            rows.append((H, r))
    update(f, s, rows)


def drop(s: dict, prune) -> None:
    """Remove the pruned clones (pruneImuStateBuffer, orcvio.cpp:2629):
    their P rows and columns zeroed, their slots and observations freed."""
    for c in np.nonzero(prune)[0]:
        cols = slice(LEG + 6 * c, LEG + 6 * c + 6)
        s["P"][cols, :] = 0.0
        s["P"][:, cols] = 0.0
    s["cvalid"] = s["cvalid"] & ~prune
    s["corder"] = np.where(prune, -1, s["corder"])
    s["uv_valid"] = s["uv_valid"] & ~prune[None, :]


def start(cfg: dict, R0, p0, v0, dtype=np.float64) -> dict:
    """A row's first state: the pose and velocity given, biases zero, no
    clone and no feature, the initial covariance on theta, v, p and the
    biases (orcvio.cpp:201-222) and none on the fixed extrinsics."""
    f = cfg["filter"]
    sw, F = f["sw_size"], f["max_features"]
    D = LEG + 6 * sw
    d = np.zeros(D, dtype)
    for sl, key in ((slice(0, 3), "init_cov_orientation"),
                    (slice(3, 6), "init_cov_velocity"),
                    (slice(6, 9), "init_cov_position"),
                    (slice(9, 12), "init_cov_gyro_bias"),
                    (slice(12, 15), "init_cov_acc_bias")):
        d[sl] = f[key]
    z3 = np.zeros(3, dtype)
    return {"t": np.array(0.0, dtype), "R": np.array(R0, dtype),
            "v": np.array(v0, dtype), "p": np.array(p0, dtype), "bg": z3,
            "ba": z3, "last_gyro": z3, "last_acc": z3,
            "cR": np.tile(np.eye(3, dtype=dtype), (sw, 1, 1)),
            "cp": np.zeros((sw, 3), dtype), "ct": np.zeros(sw, dtype),
            "corder": np.full(sw, -1, np.int64),
            "cvalid": np.zeros(sw, bool),
            "uv": np.zeros((F, sw, 2), dtype),
            "uv_valid": np.zeros((F, sw), bool),
            "fid": np.full(F, -1, np.int64), "active": np.zeros(F, bool),
            "P": np.diag(d), "next_order": 0}
