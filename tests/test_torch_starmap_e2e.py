"""The image path of the objects as a whole: ObjectVio.step_image on
config B, the port against the JAX package.

Both packages run config B (``eval/object_map_cnn.py``: 3 cars, 240x240
composite renders, the StarMap detector, SORT, keypoint ingest, init and
LM, the object-residual EKF update) in float64 on the CPU. The JAX
package runs frames 0 to LAST; the port starts at frame START from the
JAX package's state (VIO, SORT, the object table, the pose history, the
map and the detector's temporal memory, through the converters) and runs
to LAST with the JAX detector's outputs on those frames, so that the
filter sees the same keypoints: every frame's SORT state, object table,
pose history and filter state within 1e-9. The window holds the second
car's loss and its finalization with an object update (frame 116), held
to the same decision and its statistics' dof. That update's state is
held within 1e-4 only: the object block H_f (64 active rows, 45 columns)
has rank 29 there (the car's last 5 frames in the window), so the 19
rows the projection keeps are a choice among 35 null directions that
follows rounding, in the JAX package itself (ROADMAP section 3 item 24;
test_object_update_projection_follows_rounding). The port's own
detector on the same calls gives the same masks and keypoints within
1e-5 (float32 network).

Marked slow: config B over its 260 frames in both packages (the map's
counts equal, mean IoU within 0.03, as chip_smoke.py's phase 13 holds
the card).

Run as a script, ``python tests/test_torch_starmap_e2e.py
--jax-config-b``, it prints the JAX package's config-B figures that
chip_smoke.py's phase 13 holds the port to (CPU, float64, some 2.5 min).
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))
sys.path.insert(0, str(ROOT))

# the port's 15 frames: the second car is seen to frame 112, lost on
# 113-115 and finalized on 116 with an object update
START, LAST = 102, 116
TOL = 1e-9
UPDATE_TOL = 1e-4  # the filter state after the rank-deficient update


def jax_config_b(wc):
    """The JAX package's config-B pipeline configuration (its
    run_cnn_object_mapping's, at the defaults)."""
    from orcvio_tpu.config.core import FilterConfig
    from orcvio_tpu.dataio.render_object import CAR_KEYPOINTS
    from orcvio_tpu.dataio.synthetic import SimConfig
    from orcvio_tpu.objects.lm import ObjectLMConfig
    from orcvio_tpu.objects.manager import ManagerConfig
    from orcvio_tpu.objects.sort import SortConfig
    from orcvio_tpu.objects.vio_objects import ObjectVioConfig

    sim = SimConfig(n_frames=wc.n_frames, n_landmarks=400, max_obs=50,
                    uv_noise=wc.uv_noise, seed=wc.seed, radius=3.0, omega=0.5)
    fcfg = FilterConfig(sw_size=10, max_features=80, max_track_len=6,
                        imu_slab=sim.imu_slab, observation_noise=0.004,
                        object_observation_noise=0.05,
                        tri_translation_threshold=-1.0)
    return sim, ObjectVioConfig(
        filter=fcfg, lm=ObjectLMConfig(iters=25),
        manager=ManagerConfig(capacity=8, window=45, n_kps=12,
                              pose_history=256, min_frames=10,
                              smooth_keypoints=False),
        sort=SortConfig(capacity=8, max_age=3, min_hits=2, iou_threshold=0.1),
        kps_mean=tuple(map(tuple, CAR_KEYPOINTS)),
        shape_mean=(0.80, 2.00, 0.70), use_object_residual_update=True,
        merge_duplicates=True)


class Recorder:
    """A detector that records each call's inputs, output and the
    temporal memory it leaves (boxes, chosen templates)."""

    def __init__(self, detector):
        self.detector = detector
        self.K_cam = detector.K_cam
        self.calls = []

    def __call__(self, img, boxes, valid):
        out = self.detector(img, boxes, valid)
        self.calls.append((np.array(img), np.array(boxes), np.array(valid),
                           *out, self.detector._prev_boxes.copy(),
                           self.detector._prev_tmpl.copy()))
        return out


class Replayer:
    """A detector that gives the recorded outputs, for the same inputs."""

    def __init__(self, calls, K_cam):
        self.calls = list(calls)
        self.K_cam = K_cam

    def __call__(self, img, boxes, valid):
        rimg, rboxes, rvalid, kps, mask = self.calls.pop(0)[:5]
        assert np.array_equal(np.asarray(img), rimg)
        assert np.array_equal(np.asarray(boxes), rboxes)
        assert np.array_equal(np.asarray(valid), rvalid)
        return kps, mask


def _snapshot(ov):
    from orcvio_tpu_torch.convert import state_to_numpy

    return {k: state_to_numpy(getattr(ov, k))
            for k in ("vio", "sort", "table", "poses")}


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    import jax.numpy as jnp

    import orcvio_tpu.models.starmap as js
    from objects_world import jax_initial_state, port_frame
    from orcvio_tpu.dataio.render_object import CAR_KEYPOINTS
    from orcvio_tpu.filter.pipeline import FrameInput as JaxFrameInput
    from orcvio_tpu.objects.detector import StarMapKeypointDetector as JaxDet
    from orcvio_tpu.objects.vio_objects import ObjectVio as JaxObjectVio
    from orcvio_tpu_torch import convert
    from orcvio_tpu_torch.eval import object_map_cnn as cb
    from orcvio_tpu_torch.objects.detector import StarMapKeypointDetector
    from orcvio_tpu_torch.objects.vio_objects import ObjectVio
    from starmap_world import config_b_frames, jax_pretrained

    from orcvio_tpu_torch.objects import update as pupdate

    torch.set_num_threads(2)
    monkeypatch_module.setattr(js, "load_pretrained",
                               lambda path=None: jax_pretrained())
    projected = []
    project = pupdate.linalg.nullspace_project

    def spy(Hf, Hx, r):
        projected.append(tuple(x.numpy().copy() for x in (Hf, Hx, r)))
        return project(Hf, Hx, r)
    monkeypatch_module.setattr(pupdate.linalg, "nullspace_project", spy)
    imgs, boxes, valid, wc, objs, data = config_b_frames(LAST + 1)
    frames = tuple(x.numpy() for x in data.frames)
    sim, jcfg = jax_config_b(wc)
    jov = JaxObjectVio(jcfg, max_obs=sim.max_obs, dtype=jnp.float64)
    jov.set_filter_state(jax_initial_state(jcfg.filter, sim, jnp.float64))
    jdet = Recorder(JaxDet(CAR_KEYPOINTS, cb.camera_K()))
    jupdates, pupdates = [], []
    jov.update_hook = lambda oid, a, b, used, diag, e: jupdates.append(
        (oid, bool(used), {f: float(getattr(diag, f)) for f in diag._fields}))
    cls = np.zeros(cb.MAX_BOXES, np.int32)
    snaps, jp = {}, []
    for k in range(LAST + 1):
        if k == START:
            snaps["start"] = _snapshot(jov)
            start_map = {o: dict(e) for o, e in jov.object_map.items()}
            memory = (jdet.detector._prev_boxes.copy(),
                      jdet.detector._prev_tmpl.copy())
            n_calls = len(jdet.calls)
        out = jov.step_image(
            JaxFrameInput(*(jnp.asarray(x[k]) for x in frames)),
            imgs[k] * 255.0, boxes[k], cls, valid[k], jdet)
        if k >= START:
            snaps[k] = _snapshot(jov)
            jp.append(np.asarray(out.p))

    pcfg = cb.object_vio_config(cb.world_config())
    pov = ObjectVio(pcfg, max_obs=sim.max_obs, dtype=torch.float64,
                    device="cpu")
    s0, f64 = snaps["start"], torch.float64
    pov.vio = convert.vio_state_from_numpy(s0["vio"], f64, "cpu")
    pov.sort = convert.sort_state_from_numpy(s0["sort"], f64, "cpu")
    pov.table = convert.object_table_from_numpy(s0["table"], f64, "cpu")
    pov.poses = convert.pose_history_from_numpy(s0["poses"], f64, "cpu")
    pov.object_map = start_map
    pov.update_hook = lambda oid, a, b, used, diag, e: pupdates.append(
        (oid, bool(used), {f: float(getattr(diag, f)) for f in diag._fields}))
    window_calls = jdet.calls[n_calls:]
    replay = Replayer(window_calls, cb.camera_K())
    pp, psnaps = [], {}
    for k in range(START, LAST + 1):
        out = pov.step_image(port_frame(frames, k), imgs[k] * 255.0,
                             boxes[k], cls, valid[k], replay)
        psnaps[k] = _snapshot(pov)
        pp.append(out.p.numpy())
    assert not replay.calls
    pdet = StarMapKeypointDetector(CAR_KEYPOINTS, cb.camera_K(),
                                   device="cpu")
    pdet._prev_boxes, pdet._prev_tmpl = memory
    own = [(*pdet(c[0], c[1], c[2]), pdet._prev_boxes.copy(),
            pdet._prev_tmpl.copy()) for c in window_calls]
    return dict(jp=np.stack(jp), pp=np.stack(pp), snaps=snaps,
                psnaps=psnaps, jmap=jov.object_map, pmap=pov.object_map,
                jupdates=jupdates, pupdates=pupdates,
                calls=window_calls, own=own, projected=projected)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_states_within_1e9_every_frame(runs):
    """Every frame's states within 1e-9; on the update's frame the filter
    state within UPDATE_TOL (see the module's docstring)."""
    for k in range(START, LAST + 1):
        js_, ps_ = _flat(runs["snaps"][k]), _flat(runs["psnaps"][k])
        assert set(js_) <= set(ps_) | {"vio.host_initialized"}
        for name, a in js_.items():
            b = ps_[name]
            tol = UPDATE_TOL if (k == LAST and name.startswith("vio.")) \
                else TOL
            if a.dtype.kind in "biu":
                assert np.array_equal(a, b), (k, name)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                           err_msg=f"frame {k} {name}")
    np.testing.assert_allclose(runs["pp"][:-1], runs["jp"][:-1], rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(runs["pp"][-1], runs["jp"][-1], rtol=0,
                               atol=UPDATE_TOL)


def test_object_update_projection_follows_rounding(runs):
    """The window's object update projects out an H_f of rank 29 of 45
    (16 singular values under 1e-16, the 29th 2.9e-5 of the largest 20):
    the JAX package's own projected residual moves by more than 10 % when
    H_f moves by 1e-15, so no port can hold it closer than rounding does.
    The raw residual, the rows and the dof agree within 1e-9."""
    import jax.numpy as jnp

    from orcvio_tpu.math import linalg as jl

    Hf, Hx, r = runs["projected"][-1]
    act = np.abs(Hf).sum(axis=1) > 0
    assert act.sum() == 64 and Hf.shape[1] == 45
    sv = np.linalg.svd(Hf[act], compute_uv=False)
    assert int((sv > 1e-12 * sv[0]).sum()) == 29
    norms = []
    for eps in (0.0, 1e-15):
        noise = np.random.default_rng(0).normal(size=Hf.shape) * act[:, None]
        _, rp = jl.nullspace_project(jnp.asarray(Hf + eps * noise),
                                     jnp.asarray(Hx), jnp.asarray(r))
        norms.append(float(jnp.linalg.norm(rp)))
    assert abs(norms[1] - norms[0]) > 0.1 * norms[0], norms
    (_, jused, jd), (_, pused, pd) = runs["jupdates"][-1], \
        runs["pupdates"][-1]
    assert jused == pused
    for f in ("dof", "n_rows", "n_frames", "gate_ok"):
        assert pd[f] == jd[f], f
    assert abs(pd["r_rms"] - jd["r_rms"]) <= TOL


def test_window_finalizes_and_updates(runs):
    """The car is lost and finalized in the window, and its object update
    decided alike."""
    key = [u[:2] for u in runs["jupdates"]]
    assert [u[:2] for u in runs["pupdates"]] == key and key
    assert sorted(runs["pmap"]) == sorted(runs["jmap"]) and runs["jmap"]
    for oid, je in runs["jmap"].items():
        pe = runs["pmap"][oid]
        assert pe.get("ekf_update_applied") == je.get("ekf_update_applied")
        np.testing.assert_allclose(pe["wTo"], je["wTo"], rtol=0, atol=1e-8)
        np.testing.assert_allclose(pe["shape"], je["shape"], rtol=0,
                                   atol=1e-8)


def test_port_detector_on_the_window(runs):
    """The port's detector (float32 network) on the window's calls: the
    masks and the chosen templates equal and the keypoints within 1e-5 of
    the JAX detector's."""
    n = 0
    for call, (kps, mask, boxes, tmpl) in zip(runs["calls"], runs["own"]):
        assert np.array_equal(mask, call[4])
        np.testing.assert_allclose(kps, call[3], rtol=0, atol=1e-5)
        assert np.array_equal(boxes, call[5])
        assert np.array_equal(tmpl, call[6])
        n += int(mask.sum())
    assert n > 0


@pytest.mark.slow
def test_config_b_figures():
    """Config B over its 260 frames in both packages, float64."""
    from orcvio_tpu.eval.object_map_cnn import (
        run_cnn_object_mapping as jax_run)
    from orcvio_tpu_torch.eval.object_map_cnn import run_cnn_object_mapping

    torch.set_num_threads(4)
    j = jax_run()
    p = run_cnn_object_mapping(device="cpu")
    for k in ("n_matched", "n_est", "n_gt"):
        assert p[k] == j[k], k
    assert abs(p["mean_iou"] - j["mean_iou"]) <= 0.03


# ---------------------------------------------------------------------------
# --jax-config-b: the JAX package's figures for chip_smoke.py's phase 13
# ---------------------------------------------------------------------------

def _jax_config_b():
    import orcvio_tpu.eval.object_map_cnn as jcnn
    from orcvio_tpu.objects.vio_objects import ObjectVio

    counts = {"finalizations": 0, "finalized_ok": 0, "updates_tried": 0,
              "updates_applied": 0}

    class Counted(ObjectVio):
        """The JAX ObjectVio with its finalizations and updates counted."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fin = self._finalize

            def counted(*args):
                out = fin(*args)
                counts["finalizations"] += 1
                counts["finalized_ok"] += int(bool(out[0].ok))
                return out
            self._finalize = counted

            def hook(oid, a, b, used, diag, e):
                counts["updates_tried"] += 1
                counts["updates_applied"] += int(used)
            self.update_hook = hook

    jcnn.ObjectVio = Counted
    t0 = time.perf_counter()
    res = jcnn.run_cnn_object_mapping()
    return {"mean_iou": res["mean_iou"], "n_matched": res["n_matched"],
            "n_est": res["n_est"], "n_gt": res["n_gt"], **counts,
            "cpu_seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--jax-config-b" not in sys.argv:
        sys.exit("usage: python tests/test_torch_starmap_e2e.py "
                 "--jax-config-b")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps({"config_b": _jax_config_b()}))
