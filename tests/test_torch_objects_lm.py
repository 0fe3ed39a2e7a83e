"""Object initialization and the object LM: the port against the JAX
package in float64 on the CPU.

The window is one car of config A's world (tests/objects_world.py) seen
from the ground-truth cameras over WINDOW frames, its detections as the
pipeline receives them (keypoint noise, masks). Triangulation, Kabsch
(plain and RANSAC over the 220 triples, in itertools' order), both
initializations, the 25-step LM in full and lite mode and the EKF export
agree within 1e-9 (1e-8 after the LM's 25 accept-or-reject steps), the
RANSAC's decision identically. The LM's accepted steps agree until it has
converged (3 steps are held here, in one case); after that a step changes the cost by some
1e-17 of itself, and whether it is accepted follows the rounding (the
states then move by 1e-9 at most).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.objects import init as jinit
from orcvio_tpu.objects import lm as jlm
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.dataio.render_object import CAR_KEYPOINTS
from orcvio_tpu_torch.objects import init as pinit
from orcvio_tpu_torch.objects import lm as plm

sys.path.insert(0, str(Path(__file__).resolve().parent))
torch.set_num_threads(1)
TOL = 1e-9
WINDOW = 16
CFG = dict(sw_size=10, max_features=80, max_track_len=6,
           observation_noise=0.004, tri_translation_threshold=-1.0)
SHAPE_MEAN = np.array([0.80, 2.00, 0.70])


def t(x):
    return torch.as_tensor(np.array(x))


def close(p, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=0, atol=tol)


@pytest.fixture(scope="module")
def window():
    """(wTc (T, 4, 4), zs (T, 12, 2), zs_mask, zb (T, 4), zb_mask, the
    object's ground-truth wTo)."""
    from orcvio_tpu_torch.dataio import synthetic as psyn
    from orcvio_tpu_torch.eval import object_map_sim as psim

    wc = psim.WorldConfig(n_frames=60)
    data = psyn.generate(psim.world_sim(wc), R_b2c=psim.R_B2C,
                         t_c_b=psim.T_C_B, dtype=torch.float64, device="cpu")
    gt_R, gt_p = data.gt_R.numpy(), data.gt_p.numpy()
    objs = psim.make_world(wc)
    rng = np.random.default_rng(wc.seed + 1)
    rows = {}
    for k in range(wc.n_frames):
        wTc = np.eye(4)
        wTc[:3, :3] = gt_R[k] @ psim.R_B2C.T
        wTc[:3, 3] = gt_p[k] + gt_R[k] @ psim.T_C_B
        boxes, _, kps, kmask, valid, truth = psim.analytic_detections(
            wc, objs, wTc, rng)
        for m in np.nonzero(valid)[0]:
            rows.setdefault(int(truth[m]), []).append(
                (wTc, kps[m], kmask[m], boxes[m]))
    oid = max(rows, key=lambda i: len(rows[i]))
    seen = rows[oid][:WINDOW]
    assert len(seen) == WINDOW
    wTc, zs, zs_mask, zb = (np.stack(x) for x in zip(*seen))
    zs_mask = zs_mask.copy()
    zs_mask[3, :4] = False  # some keypoints missing
    zb_mask = np.ones(WINDOW, bool)
    zb_mask[5] = False
    return wTc, zs, zs_mask, zb, zb_mask, objs[oid]["wTo"]


def test_nanmedian():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 9))
    x[rng.uniform(size=x.shape) < 0.3] = np.nan
    x[2] = np.nan
    close(pinit.nanmedian(t(x), 1), jnp.nanmedian(jnp.asarray(x), axis=1))


def test_triangulate_keypoints(window):
    wTc, zs, zs_mask, *_ = window
    args = (zs, zs_mask, wTc[:, :3, :3], wTc[:, :3, 3])
    jp, jv = jax.jit(lambda *a: jinit.triangulate_keypoints(
        JaxConfig(**CFG), *a))(*map(jnp.asarray, args))
    pp, pv = pinit.triangulate_keypoints(FilterConfig(**CFG), *map(t, args))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert pv.sum() >= 8
    close(pp.numpy()[pv.numpy()], np.asarray(jp)[np.asarray(jv)])


def test_kabsch_and_ransac(window):
    wTc, zs, zs_mask, *_ = window
    rng = np.random.default_rng(2)
    wTo = np.asarray(jax.jit(jinit.se3.exp)(jnp.asarray(
        [1.0, -2.0, 0.5, 0.1, -0.2, 1.3])))
    dst = 1.05 * CAR_KEYPOINTS @ wTo[:3, :3].T + wTo[:3, 3]
    dst = dst + rng.normal(size=dst.shape) * 0.02
    dst[4] += [3.0, 0.0, 0.0]  # an identity-swapped keypoint
    valid = np.ones(12, bool)
    valid[7] = False
    close(pinit.kabsch_umeyama(t(CAR_KEYPOINTS), t(dst), t(valid)),
          jax.jit(jinit.kabsch_umeyama)(jnp.asarray(CAR_KEYPOINTS),
                                        jnp.asarray(dst), jnp.asarray(valid)))
    jT, jok = jax.jit(jinit.kabsch_ransac)(jnp.asarray(CAR_KEYPOINTS),
                                           jnp.asarray(dst),
                                           jnp.asarray(valid))
    pT, pok = pinit.kabsch_ransac(t(CAR_KEYPOINTS), t(dst), t(valid))
    assert bool(pok) == bool(jok) and bool(pok)
    close(pT, jT)


@pytest.fixture(scope="module")
def inits(window):
    wTc, zs, zs_mask, zb, zb_mask, _ = window
    args = (zs, zs_mask, wTc[:, :3, :3], wTc[:, :3, 3], CAR_KEYPOINTS)
    kw = dict(zb=zb, zb_mask=zb_mask, shape_ellipsoid=SHAPE_MEAN)
    j = jax.jit(lambda *a, **k: jinit.object_initialization(
        JaxConfig(**CFG), *a, **k))(*map(jnp.asarray, args),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    p = pinit.object_initialization(FilterConfig(**CFG), *map(t, args),
                                    **{k: t(v) for k, v in kw.items()})
    return j, p


def test_object_initialization(inits, window):
    (jT, jok, jk, jv), (pT, pok, pk, pv) = inits
    assert bool(pok) == bool(jok) and bool(pok)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    close(pT, jT)
    close(pk.numpy()[pv.numpy()], np.asarray(jk)[np.asarray(jv)])
    # within a metre of the car
    assert np.linalg.norm(pT.numpy()[:3, 3] - window[5][:3, 3]) < 1.0


def test_object_initialization_lite(window):
    wTc, _, _, zb, *_ = window
    args = (zb[0], wTc[0, :3, :3].T, wTc[0, :3, 3], SHAPE_MEAN)
    jT, jok = jax.jit(jinit.object_initialization_lite)(
        *map(jnp.asarray, args))
    pT, pok = pinit.object_initialization_lite(*map(t, args))
    assert bool(pok) == bool(jok)
    close(pT, jT)


def lm_data(window, mod):
    wTc, zs, zs_mask, zb, zb_mask, _ = window
    cTw = np.linalg.inv(wTc)
    fm = np.ones(WINDOW, bool)
    fm[9] = False
    xs = (cTw, zs, zs_mask & fm[:, None], zb, zb_mask & fm, fm,
          CAR_KEYPOINTS, SHAPE_MEAN)
    conv = jnp.asarray if mod is jlm else t
    return mod.ObjectLMData(*map(conv, xs))


@pytest.mark.parametrize("lite,left,use_new,huber", [
    (False, True, False, float("inf")), (False, False, True, 0.05),
    (True, True, False, float("inf")), (True, False, True, float("inf"))])
def test_lm_optimize_and_export(window, inits, lite, left, use_new, huber):
    (jT, *_), _ = inits
    U, _, Vt = np.linalg.svd(np.asarray(jT)[:3, :3])
    wTo0 = np.asarray(jT).copy()
    wTo0[:3, :3] = U @ Vt
    kw = dict(iters=25, lite=lite, use_left_perturbation=left,
              use_new_bbox_residual=use_new, huber_epsilon=huber)
    jc, pc = jlm.ObjectLMConfig(**kw), plm.ObjectLMConfig(**kw)
    jst0 = jlm.ObjectLMState(*map(jnp.asarray,
                                  (wTo0, SHAPE_MEAN, CAR_KEYPOINTS)))
    pst0 = plm.ObjectLMState(*map(t, (wTo0, SHAPE_MEAN, CAR_KEYPOINTS)))
    jd, pd = lm_data(window, jlm), lm_data(window, plm)
    opt = jax.jit(jlm.optimize, static_argnums=0)
    if not lite and left:  # one case: a compile of its own
        early = dict(iters=3)
        jn = opt(jc._replace(**early), jst0, jd)[2]
        pn = plm.optimize(pc._replace(**early), pst0, pd)[2]
        assert int(pn) == int(jn) and int(pn) >= 1
    jst, jcost, _ = opt(jc, jst0, jd)
    pst, pcost, _ = plm.optimize(pc, pst0, pd)
    assert abs(float(pcost) - float(jcost)) <= 1e-12 * max(1.0, float(jcost))
    for a, b in zip(pst, jst):
        close(a, b, 1e-8)
    jexp = jax.jit(jlm.export_for_update, static_argnums=0)(
        jc._replace(lite=False), jst, jd)
    pexp = plm.export_for_update(pc._replace(lite=False), pst, pd)
    for a, b in zip(pexp, jexp):
        close(a, b, 1e-8)
