"""The port's trajectory evaluation against the JAX package's.

umeyama (with and without scale), ate under each alignment ("se3",
"sim3", "posyaw", "none" and the default, which is "se3" in both) and
relative_errors on the same arrays give the same numbers within 1e-9.
The trajectory is a seeded random walk with a similarity transform, noise
and timestamp jitter applied, so association drops some samples.
"""
import numpy as np
import pytest

from orcvio_tpu.eval import trajectory as jtraj
from orcvio_tpu_torch.eval import trajectory as ptraj

TOL = 1e-9


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def traj():
    rng = np.random.default_rng(5)
    n = 400
    t_gt = 0.05 * np.arange(n)
    p_gt = np.cumsum(rng.normal(size=(n, 3)) * 0.1, axis=0)
    q_gt = _quats(rng, n)
    a = 0.7
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1.0]])
    p_est = 1.3 * p_gt @ R.T + [0.5, -2.0, 0.1] \
        + rng.normal(size=(n, 3)) * 0.02
    q_est = _quats(rng, n) * 0.05 + q_gt
    q_est /= np.linalg.norm(q_est, axis=1, keepdims=True)
    t_est = t_gt + rng.normal(size=n) * 0.012  # some fall outside max_dt
    keep = np.sort(rng.choice(n, 350, replace=False))
    return t_est[keep], p_est[keep], q_est[keep], t_gt, p_gt, q_gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_matches_jax(traj, with_scale):
    t_est, p_est, _, t_gt, p_gt, _ = traj
    ie, ig = jtraj.associate(t_est, t_gt)
    src, dst = p_est[ie], p_gt[ig]
    js, jR, jt = jtraj.umeyama(src, dst, with_scale=with_scale)
    ps, pR, pt = ptraj.umeyama(src, dst, with_scale=with_scale)
    assert abs(ps - js) < TOL
    np.testing.assert_allclose(pR, jR, rtol=0, atol=TOL)
    np.testing.assert_allclose(pt, jt, rtol=0, atol=TOL)
    if with_scale:
        assert abs(ps - 1 / 1.3) < 0.05


@pytest.mark.parametrize("alignment", [None, "se3", "sim3", "posyaw", "none"])
def test_ate_matches_jax(traj, alignment):
    kw = {} if alignment is None else {"alignment": alignment}
    j = jtraj.ate(*traj, **kw)
    p = ptraj.ate(*traj, **kw)
    assert p.keys() == j.keys()
    assert p["n_matched"] == j["n_matched"] < len(traj[0])
    for key in ("rmse_trans", "rmse_rot_deg", "mean_trans", "median_trans",
                "scale"):
        assert abs(p[key] - j[key]) < TOL, (key, p[key], j[key])


def test_ate_defaults_to_se3(traj):
    assert ptraj.ate(*traj) == ptraj.ate(*traj, alignment="se3")
    assert ptraj.ate(*traj) != ptraj.ate(*traj, alignment="posyaw")


def test_ate_needs_three_associations(traj):
    t_est, p_est, q_est, t_gt, p_gt, q_gt = traj
    with pytest.raises(ValueError, match="too few"):
        ptraj.ate(t_est[:2], p_est[:2], q_est[:2], t_gt, p_gt, q_gt)


def test_relative_errors_match_jax(traj):
    t_est, p_est, _, t_gt, p_gt, _ = traj
    dist = (1.0, 2.5, 4.0, 1e3)  # the last spans more than the track
    j = jtraj.relative_errors(t_est, p_est, t_gt, p_gt, distances=dist)
    p = ptraj.relative_errors(t_est, p_est, t_gt, p_gt, distances=dist)
    assert p.keys() == j.keys() and len(p) == 3
    for d in p:
        assert abs(p[d] - j[d]) < TOL
