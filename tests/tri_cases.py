"""Seeded triangulation inputs for the K6 tests (``ops/triangulate.py``),
in PyTorch alone: B rows, each a window of S camera poses along a short
path and F compacted tracks of T observations of landmarks 2-12 m ahead,
with the filter's layout (``filter/tracks.py:CompactTracks``).

Each track observes T distinct slots in time order. Its mask is a valid
prefix of n_obs observations, n_obs drawn from 0..T (so some tracks have
fewer than 2), as the filter's tracks are; with `holes`, a hole is punched
in a few prefixes, as the object layer's second pass masks outliers
anywhere. With `outliers`, one valid observation of every third track of
3 or more is moved 0.05-0.2 off its landmark's image, well past the
filter's Huber threshold (0.01), so the weights and the steps the loop
takes depend on it. `baseline` scales the camera path (0.15 m a slot at
1): at 0.02 the cameras sit within some 3 mm of each other, as at a static
start, where float32 arithmetic leaves the depth to rounding. Masked
entries carry garbage coordinates. Where asked, the last row is masked out
whole. The prior points (the object layer's
``p_init_world``) are, in turn, the landmark moved by 0.3 m, NaN in one
coordinate, 1 m behind the anchor camera, and 30 m away.
"""
import numpy as np
import torch


def _rot(w):
    """Rodrigues: the rotation of axis-angle w (3,)."""
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def tri_rows(B, F, T, S, seed, dtype=torch.float64, device="cpu",
             prior=False, holes=False, dead_row=False, noise=1e-3,
             outliers=False, baseline=1.0):
    """(uv, mask, slot, n_obs, R_c2w, t_c_w, p_init_world or None), each
    with a leading axis of B rows."""
    rng = np.random.default_rng(seed)
    uv = np.empty((B, F, T, 2))
    mask = np.zeros((B, F, T), bool)
    slot = np.empty((B, F, T), np.int64)
    R = np.empty((B, S, 3, 3))
    t = np.empty((B, S, 3))
    p_init = np.empty((B, F, 3))
    for b in range(B):
        heading = rng.normal(size=3) * [0.3, 0.1, 0.3]
        for s in range(S):
            R[b, s] = _rot(heading + rng.normal(size=3) * 0.02)
            t[b, s] = baseline * (np.array([0.15 * s, 0.03 * np.sin(s),
                                            0.02 * s])
                                  + rng.normal(size=3) * 0.01)
        for f in range(F):
            slots = np.sort(rng.choice(S, size=T, replace=False))
            slot[b, f] = slots
            anchor_cam = R[b, slots[-1]], t[b, slots[-1]]
            pc = np.array([rng.uniform(-2, 2), rng.uniform(-1.5, 1.5),
                           rng.uniform(2, 12)])
            pw = anchor_cam[0] @ pc + anchor_cam[1]
            for k, s in enumerate(slots):
                q = R[b, s].T @ (pw - t[b, s])
                uv[b, f, k] = q[:2] / q[2] + rng.normal(size=2) * noise
            n = rng.integers(0, T + 1)
            mask[b, f, :n] = True
            if holes and n >= 4 and f % 5 == 0:
                mask[b, f, rng.integers(0, n - 1)] = False
            if outliers and n >= 3 and f % 3 == 0:
                k = rng.integers(0, n)
                d = rng.normal(size=2)
                uv[b, f, k] += d / np.linalg.norm(d) * rng.uniform(0.05, 0.2)
            uv[b, f][~mask[b, f]] = rng.normal(size=(int((~mask[b, f]).sum()),
                                                     2)) * 5
            kind = f % 4
            if kind == 0:
                p_init[b, f] = pw + rng.normal(size=3) * 0.3
            elif kind == 1:
                p_init[b, f] = pw
                p_init[b, f, rng.integers(0, 3)] = np.nan
            elif kind == 2:  # behind the newest valid camera
                a = max(int(mask[b, f].sum()) - 1, 0)
                Ra, ta = R[b, slots[a]], t[b, slots[a]]
                p_init[b, f] = Ra @ np.array([0.1, 0.0, -1.0]) + ta
            else:
                p_init[b, f] = pw + 30.0 * rng.normal(size=3)
    if dead_row:
        mask[-1] = False
    n_obs = mask.sum(axis=2).astype(np.int32)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    i = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return (f(uv), i(mask), i(slot), i(n_obs), f(R), f(t),
            f(p_init) if prior else None)


def tri_cost(uv, mask, slot, n_obs, R_c2w, t_c_w, x):
    """Each track's sum of squared reprojection residuals over its valid
    observations at x = (alpha, beta, rho) in its anchor camera (its
    newest valid observation's), in float64: the objective the
    triangulation's loop lowers, written apart from it. Rows on a leading
    axis; returns (B, F)."""
    f = torch.float64
    uv, R, t, x = uv.to(f), R_c2w.to(f), t_c_w.to(f), x.to(f)
    rows = torch.arange(uv.shape[0], device=uv.device)[:, None]
    a = torch.clamp(n_obs.long() - 1, min=0)
    slot_a = torch.take_along_dim(slot, a[..., None], dim=-1)[..., 0]
    Rk, tk = R[rows[..., None], slot], t[rows[..., None], slot]
    Ra, ta = R[rows, slot_a], t[rows, slot_a]
    ab1 = torch.cat([x[..., :2], torch.ones_like(x[..., :1])], dim=-1)
    d = torch.einsum("bfij,bfj->bfi", Ra, ab1)[:, :, None] \
        + x[..., 2:3, None] * (ta[:, :, None] - tk)
    h = torch.einsum("bftji,bftj->bfti", Rk, d)
    r = h[..., :2] / h[..., 2:3] - uv
    return torch.where(mask[..., None], r * r, 0.0).sum((-2, -1))
