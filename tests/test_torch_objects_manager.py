"""The object manager, finalization, the object EKF update and the staged
map: the port against the JAX package in float64 on the CPU.

Config A's detections (tests/objects_world.py) run through the port's
SORT (held to JAX's in test_torch_objects_sort.py) and its association;
both packages then ingest the same tracks frame by frame (tables
identical but for the keypoint filters' floats, within 1e-9), pick the
same rows to finalize and free, and finalize the first full window the
same, in full and in lite (bbox-only) mode (within 1e-8 after the LM). The object update runs on a window of 10
clones at the ground-truth poses, moved off them: the projection's row
basis differs (the JAX package's complete QR against the port's
Householder loop at k = 45), so the update is held through its
invariants: used, the statistic, its dof, the rows, the new P (K4's plain
version on the CPU), clones and IMU state, within 1e-9.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.config.core import FilterConfig as JaxConfig
from orcvio_tpu.filter.augment import state_augmentation as jax_augment
from orcvio_tpu.filter.pipeline import build_chi2_table as jax_chi2
from orcvio_tpu.filter.state import FilterState as JaxFilterState
from orcvio_tpu.objects import manager as jman
from orcvio_tpu.objects import staged as jstaged
from orcvio_tpu.objects import update as jupd
from orcvio_tpu.objects.lm import ObjectLMConfig as JaxLMConfig
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.convert import (filter_state_from_numpy,
                                      map_table_from_numpy,
                                      object_table_from_numpy,
                                      pose_history_from_numpy,
                                      state_to_numpy)
from orcvio_tpu_torch.dataio.render_object import CAR_KEYPOINTS
from orcvio_tpu_torch.filter.pipeline import build_chi2_table
from orcvio_tpu_torch.objects import manager as pman
from orcvio_tpu_torch.objects import staged as pstaged
from orcvio_tpu_torch.objects import update as pupd
from orcvio_tpu_torch.objects.lm import ObjectLMConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
torch.set_num_threads(1)
TOL = 1e-9
N_FRAMES = 30
CFG = dict(sw_size=10, max_features=80, max_track_len=6,
           observation_noise=0.004, tri_translation_threshold=-1.0)
SHAPE_MEAN = np.array([0.80, 2.00, 0.70])


def t(x):
    return torch.as_tensor(np.array(x))


def close(p, j, tol=TOL):
    np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=0, atol=tol)


def same_table(pt, jt, tol=TOL):
    pd, jd = state_to_numpy(pt), state_to_numpy(jt)
    for f in ("oid", "class_id", "n", "zs_mask", "zb_mask"):
        np.testing.assert_array_equal(pd[f], jd[f], f)
    for f in ("zs", "zb", "t"):
        close(pd[f], jd[f], tol)
    for f in ("x", "P", "t"):
        close(pd["kp_kf"][f], jd["kp_kf"][f], tol)
    np.testing.assert_array_equal(pd["kp_kf"]["init"], jd["kp_kf"]["init"])


@pytest.fixture(scope="module")
def run():
    """Both managers over N_FRAMES frames; the first finalized window."""
    from objects_world import port_config
    from orcvio_tpu_torch.dataio import synthetic as psyn
    from orcvio_tpu_torch.eval import object_map_sim as psim
    from orcvio_tpu_torch.objects.sort import SortState, sort_step
    from orcvio_tpu_torch.objects.vio_objects import associate

    wc = psim.WorldConfig(n_frames=N_FRAMES)
    data = psyn.generate(psim.world_sim(wc), R_b2c=psim.R_B2C,
                         t_c_b=psim.T_C_B, dtype=torch.float64, device="cpu")
    gt_R, gt_p = data.gt_R.numpy(), data.gt_p.numpy()
    dets = psim.detection_stream(wc, psim.make_world(wc), gt_R, gt_p,
                                 np.random.default_rng(wc.seed + 1))
    ocfg = port_config(wc, min_frames=8, window=16, pose_history=64)
    mc = ocfg.manager
    jmc = jman.ManagerConfig(**mc._asdict())
    ss = SortState.create(ocfg.sort, torch.float64, "cpu")
    pt = pman.ObjectTable.create(mc, torch.float64, "cpu")
    jt = jman.ObjectTable.create(jmc, jnp.float64)
    ph = pman.PoseHistory.create(mc.pose_history, torch.float64, "cpu")
    jh = jman.PoseHistory.create(jmc.pose_history, jnp.float64)
    j_ingest = jax.jit(lambda *a: jman.ingest(jmc, *a))
    finals, frames_t = [], data.frames.t.numpy()
    for k in range(N_FRAMES):
        wTc = np.eye(4)
        wTc[:3, :3] = gt_R[k] @ psim.R_B2C.T
        wTc[:3, 3] = gt_p[k] + gt_R[k] @ psim.T_C_B
        ph = ph.push(t(wTc), t(frames_t[k]))
        jh = jh.push(jnp.asarray(wTc), jnp.asarray(frames_t[k]))
        boxes, classes, kps, kmask, valid = (t(x[k]) for x in dets)
        ss, so = sort_step(ocfg.sort, ss, boxes, classes, valid)
        k_kps, k_mask, has = associate(so, boxes, valid, kps, kmask)
        args = (t(frames_t[k]), torch.where(has, so.track_id, -1),
                so.class_id, so.bboxes, k_kps, k_mask, has)
        pt = pman.ingest(mc, pt, *args)
        jt = j_ingest(jt, *(jnp.asarray(a.numpy()) for a in args))
        same_table(pt, jt)
        fin, junk = pman.rows_to_finalize(mc, pt, so.lost_id)
        jfin, jjunk = jman.rows_to_finalize(jmc, jt,
                                            jnp.asarray(so.lost_id.numpy()))
        np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
        np.testing.assert_array_equal(junk.numpy(), np.asarray(jjunk))
        for r in np.nonzero(fin.numpy())[0]:
            finals.append((k, int(r), jax.tree.map(np.asarray, jt)))
        kill = fin | junk
        pt = pman.free_rows(pt, kill)
        jt = jman.free_rows(jt, jnp.asarray(kill.numpy()))
        if k == N_FRAMES // 2:  # onward from the JAX table
            pt = object_table_from_numpy(state_to_numpy(jt), torch.float64,
                                         "cpu")
    same_table(pt, jt)
    return dict(finals=finals, ph=ph, jh=jh, mc=mc, gt_R=gt_R, gt_p=gt_p,
                frames_t=frames_t)


def test_pose_history(run):
    times = run["frames_t"][[3, 7, 29]] + np.array([0.0, 1e-9, 0.01])
    pw, pf = run["ph"].lookup(t(times))
    jw, jf = run["jh"].lookup(jnp.asarray(times))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    close(pw, jw)
    conv = pose_history_from_numpy(state_to_numpy(run["jh"]), torch.float64,
                                   "cpu")
    close(conv.wTc, run["jh"].wTc)
    assert int(conv.head) == int(run["jh"].head) == N_FRAMES


@pytest.fixture(scope="module")
def finalized(run):
    assert run["finals"], "no window finalized"
    k, r, table = run["finals"][0]
    mc = run["mc"]
    fv = np.arange(mc.window) < table.n[r]
    win = (table.zs[r], table.zs_mask[r], table.zb[r], table.zb_mask[r],
           table.t[r], fv)
    lm = dict(iters=25)
    j = jax.jit(lambda *a: jman.finalize_object(
        JaxConfig(**CFG), JaxLMConfig(**lm), *a))(
        *map(jnp.asarray, win), run["jh"], jnp.asarray(CAR_KEYPOINTS),
        jnp.asarray(SHAPE_MEAN))
    p = pman.finalize_object(FilterConfig(**CFG), ObjectLMConfig(**lm),
                             *map(t, win), run["ph"], t(CAR_KEYPOINTS),
                             t(SHAPE_MEAN))
    return j, p, table.t[r], k


def test_finalize_object(finalized):
    (jfin, jexp, jw, _), (pfin, pexp, pw, _), _, _ = finalized
    assert bool(pfin.ok) == bool(jfin.ok) and bool(pfin.ok)
    for a, b in zip(pfin, jfin):
        close(a, b, 1e-8)
    for a, b in zip(pexp, jexp):
        close(a, b, 1e-8)
    close(pw, jw)


def test_finalize_object_lite(run):
    """The bbox-only finalization (ObjectLMLite): init from the first
    valid bbox, the 9-dof LM."""
    _, r, table = run["finals"][0]
    fv = np.arange(run["mc"].window) < table.n[r]
    win = (table.zs[r], table.zs_mask[r], table.zb[r], table.zb_mask[r],
           table.t[r], fv)
    lm = dict(iters=25, lite=True)
    jfin, jexp, _, _ = jax.jit(lambda *a: jman.finalize_object(
        JaxConfig(**CFG), JaxLMConfig(**lm), *a))(
        *map(jnp.asarray, win), run["jh"], jnp.asarray(CAR_KEYPOINTS),
        jnp.asarray(SHAPE_MEAN))
    pfin, pexp, _, _ = pman.finalize_object(
        FilterConfig(**CFG), ObjectLMConfig(**lm), *map(t, win), run["ph"],
        t(CAR_KEYPOINTS), t(SHAPE_MEAN))
    assert bool(pfin.ok) == bool(jfin.ok) and bool(pfin.ok)
    for a, b in zip(pfin, jfin):
        close(a, b, 1e-8)
    for a, b in zip(pexp, jexp):
        close(a, b, 1e-8)


@pytest.fixture(scope="module")
def filter_states(run, finalized):
    """A 10-clone window at the ground truth of the object's last 10
    frames, moved off it, both packages."""
    _, _, obj_t, k_last = finalized
    cfg = JaxConfig(**CFG)
    st = JaxFilterState.create(cfg, jnp.float64)
    st = st.replace(R_b2c=jnp.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
                                       [1.0, 0.0, 0.0]]),
                    t_c_b=jnp.asarray([0.05, 0.02, 0.0]))
    rng = np.random.default_rng(3)
    aug = jax.jit(lambda s: jax_augment(cfg, s))
    for k in range(k_last - 9, k_last + 1):
        imu = st.imu.replace(
            R=jnp.asarray(run["gt_R"][k]),
            p=jnp.asarray(run["gt_p"][k] + rng.normal(size=3) * 0.01))
        st = aug(st.replace(imu=imu, t=jnp.asarray(run["frames_t"][k])))
    A = rng.normal(size=(cfg.state_dim, cfg.state_dim)) * 1e-3
    st = st.replace(P=st.P + jnp.asarray(A @ A.T))
    return st, filter_state_from_numpy(state_to_numpy(st), torch.float64,
                                       "cpu")


@pytest.mark.parametrize("transport", [True, False])
def test_object_ekf_update(finalized, filter_states, transport):
    (_, jexp, jw, _), (_, pexp, pw, _), obj_t, _ = finalized
    jst, pst = filter_states
    kw = dict(CFG, object_residual_transport=transport)
    jcfg, pcfg = JaxConfig(**kw), FilterConfig(**kw)
    assert jst.P.shape == (82, 82)
    jout, jused, jdiag = jax.jit(lambda *a: jupd.object_ekf_update(
        jcfg, *a))(jst, jexp, jw, jnp.asarray(obj_t),
                   jax_chi2(jcfg, jnp.float64))
    pout, pused, pdiag = pupd.object_ekf_update(
        pcfg, pst, pexp, pw, t(obj_t), build_chi2_table(pcfg, torch.float64,
                                                        "cpu"))
    assert bool(pused) == bool(jused) and bool(pused)
    for f in ("dof", "n_rows", "n_frames", "gate_ok"):
        assert int(getattr(pdiag, f)) == int(getattr(jdiag, f)), f
    assert int(pdiag.n_rows) == 10 * 28 and int(pdiag.n_frames) == 10
    for f in ("gamma", "threshold", "r_rms", "rp_rms", "dx_clone_p"):
        a, b = float(getattr(pdiag, f)), float(getattr(jdiag, f))
        assert abs(a - b) <= TOL * max(1.0, abs(b)), (f, a, b)
    close(pout.P, jout.P)
    close(pout.clones.p, jout.clones.p)
    close(pout.clones.R, jout.clones.R)
    close(pout.imu.p, jout.imu.p)


def test_build_object_H_and_matching(finalized, filter_states):
    (_, jexp, jw, _), (_, pexp, pw, _), obj_t, _ = finalized
    jst, pst = filter_states
    js, jok = jupd.match_timestamps(jnp.asarray(obj_t), jst.clones.t,
                                    jst.clones.valid)
    ps, pok = pupd.match_timestamps(t(obj_t), pst.clones.t, pst.clones.valid)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    jcfg, pcfg = JaxConfig(**CFG), FilterConfig(**CFG)
    j = jax.jit(lambda *a: jupd.build_object_H(jcfg, *a))(
        jst, jexp, jw, jnp.asarray(obj_t))
    p = pupd.build_object_H(pcfg, pst, pexp, pw, t(obj_t))
    for a, b in zip(p, j):
        close(a, b)


def test_map_insert():
    """Inserts, a merge that keeps the longer track, a merge that does
    not, a class that does not merge, a full map; onward from the JAX
    map through ``convert.map_table_from_numpy``."""
    rng = np.random.default_rng(4)
    jm = jstaged.MapTable.create(3, 12, jnp.float64)
    pm = pstaged.MapTable.create(3, 12, torch.float64, "cpu")
    ins = jax.jit(jstaged.map_insert, static_argnums=8)
    cases = [((0, 0, 0), 0, 10, True), ((5, 0, 0), 0, 12, True),
             ((0.5, 0, 0), 0, 20, True), ((0.4, 0, 0), 0, 5, True),
             ((5, 0.2, 0), 1, 9, True), ((9, 9, 0), 0, 9, False),
             ((20, 0, 0), 0, 30, True), ((-9, 0, 0), 2, 30, True)]
    for i, (c, cls, n, do) in enumerate(cases):
        wTo = np.eye(4)
        wTo[:3, 3] = c
        args = (wTo, rng.normal(size=3), rng.normal(size=(12, 3)), cls, n,
                rng.uniform(), do)
        jm = ins(jm, *(jnp.asarray(a) for a in args), 2.0)
        pm = pstaged.map_insert(pm, *(t(a) for a in args), 2.0)
        pd, jd = state_to_numpy(pm), state_to_numpy(jm)
        for f in jd:
            close(pd[f], jd[f])
        if i == 3:
            pm = map_table_from_numpy(state_to_numpy(jm), torch.float64, "cpu")
    assert bool(pm.valid.all())
