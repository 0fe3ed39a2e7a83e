"""The object slice as a whole on the host orchestrator: ObjectVio.step,
the port against the JAX package.

Both packages run config A's world (tests/objects_world.py) cut to
N_FRAMES frames, min_frames 8 and a 16-frame window, in float64 on the
CPU, from the same ground-truth filter state, on the same frames and
detections. Every frame: SORT, keypoint ingest, finalization of lost or
full objects (triangulation, RANSAC Kabsch, the 25-step object LM) and
the object-residual EKF update (K4's plain version on the CPU). The same
objects finalize on the same frames with the same update decisions (at
least one applied), the map's poses agree within 1e-6 m and the
trajectory within 1e-6 m.

Run as a script, ``python tests/test_torch_objects_e2e.py
--jax-object-map``, it prints the JAX package's figures that
chip_smoke.py's phase 12 holds the port to (CPU, some 3 min): config A
at ``scripts/object_map_eval.py --quick``'s size
(``run_object_mapping(WorldConfig(n_objects=6, n_frames=150))``,
float64) with and without the object update, and bench.py's staged
replay configuration (float32, 300 frames, 12 cars, map capacity 32).
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))
sys.path.insert(0, str(ROOT))

N_FRAMES = 20
CUTS = dict(min_frames=8, window=16, pose_history=128)
TOL_M = 1e-6


def _jax_run(w):
    import jax.numpy as jnp

    from orcvio_tpu.filter.pipeline import FrameInput as JaxFrameInput
    from orcvio_tpu.objects.vio_objects import ObjectVio as JaxObjectVio

    ov = JaxObjectVio(w["jcfg"], max_obs=w["sim"].max_obs, dtype=jnp.float64)
    ov.set_filter_state(w["jstate"])
    return _drive(ov, w, lambda k: JaxFrameInput(
        *(jnp.asarray(x[k]) for x in w["frames"])))


def _port_run(w):
    from objects_world import port_frame
    from orcvio_tpu_torch.convert import filter_state_from_numpy, state_to_numpy
    from orcvio_tpu_torch.objects.vio_objects import ObjectVio

    ov = ObjectVio(w["pcfg"], max_obs=w["sim"].max_obs, dtype=torch.float64,
                   device="cpu")
    ov.set_filter_state(filter_state_from_numpy(
        state_to_numpy(w["jstate"]), torch.float64, "cpu"))
    return _drive(ov, w, lambda k: port_frame(w["frames"], k))


def _drive(ov, w, frame):
    """Per frame p, every update tried (frame, oid, used, diag) and the
    final map."""
    updates, ps, k_now = [], [], [0]

    def hook(oid, fs_before, fs_after, used, diag, entry):
        updates.append(dict(
            frame=k_now[0], oid=int(oid), used=bool(used),
            clones_p=np.asarray(fs_after.clones.p),
            P=np.asarray(fs_after.P),
            **{f: float(getattr(diag, f)) for f in diag._fields}))

    ov.update_hook = hook
    for k in range(w["wc"].n_frames):
        k_now[0] = k
        out = ov.step(frame(k), *(x[k] for x in w["dets"]))
        ps.append(np.asarray(out.p))
    return dict(p=np.stack(ps), updates=updates, map=ov.object_map)


@pytest.fixture(scope="module")
def runs():
    from objects_world import world

    torch.set_num_threads(1)
    w = world(N_FRAMES, **CUTS)
    return _jax_run(w), _port_run(w)


def test_same_finalizations_and_update_decisions(runs):
    jr, pr = runs
    key = [(u["frame"], u["oid"], u["used"]) for u in jr["updates"]]
    assert [(u["frame"], u["oid"], u["used"]) for u in pr["updates"]] == key
    assert any(u["used"] for u in pr["updates"]), key


def test_trajectory_within_1e6_m(runs):
    jr, pr = runs
    err = np.abs(jr["p"] - pr["p"]).max()
    assert err < TOL_M, err


def test_map_within_1e6_m(runs):
    jr, pr = runs
    assert sorted(jr["map"]) == sorted(pr["map"]) and pr["map"]
    for oid, je in jr["map"].items():
        pe = pr["map"][oid]
        assert pe["class_id"] == je["class_id"]
        assert pe["n_tracks"] == je["n_tracks"]
        assert pe.get("ekf_update_applied") == je.get("ekf_update_applied")
        np.testing.assert_allclose(pe["timestamps"], je["timestamps"],
                                   atol=1e-12)
        np.testing.assert_allclose(pe["wTo"], je["wTo"], atol=TOL_M)
        np.testing.assert_allclose(pe["kps_world"], je["kps_world"],
                                   atol=TOL_M)
        np.testing.assert_allclose(pe["shape"], je["shape"], atol=TOL_M)
        assert abs(pe["lm_cost"] - je["lm_cost"]) <= 1e-6 * max(
            1.0, je["lm_cost"])


def test_update_invariants(runs):
    """The update's invariants under the projection's row basis (the JAX
    package takes a complete QR at k = 45, the port Householder): the
    statistic, its dof and threshold, the rows, the clones and P after
    each update."""
    jr, pr = runs
    for ju, pu in zip(jr["updates"], pr["updates"]):
        for f in ("dof", "n_rows", "n_frames", "gate_ok"):
            assert pu[f] == ju[f], (f, ju, pu)
        for f in ("gamma", "threshold", "r_rms", "rp_rms", "dx_clone_p"):
            assert abs(pu[f] - ju[f]) <= 1e-6 * max(1.0, abs(ju[f])), f
        np.testing.assert_allclose(pu["clones_p"], ju["clones_p"], atol=TOL_M)
        np.testing.assert_allclose(pu["P"], ju["P"], atol=1e-9)


# ---------------------------------------------------------------------------
# --jax-object-map: the JAX package's figures for chip_smoke.py's phase 12
# ---------------------------------------------------------------------------

# phase 12's config A world: scripts/object_map_eval.py --quick's (6 cars
# over 150 frames); the 300-frame world stays in
# tests/test_torch_objects_config_a.py
CHIP_WORLD = dict(n_objects=6, n_frames=150)


def _config_a(use_object_update):
    from orcvio_tpu.eval.object_map_sim import WorldConfig, run_object_mapping

    t0 = time.perf_counter()
    res = run_object_mapping(WorldConfig(**CHIP_WORLD),
                             use_object_update=use_object_update,
                             collect_diag=True)
    secs = time.perf_counter() - t0
    n_frames = CHIP_WORLD["n_frames"]
    return {"mean_iou": res["mean_iou"], "n_matched": res["n_matched"],
            "n_est": res["n_est"], "n_gt": res["n_gt"], "ate_m": res["ate_m"],
            "updates_tried": len(res["diag"]),
            "updates_applied": sum(d["used"] for d in res["diag"]),
            "cpu_ms_per_frame": 1e3 * secs / n_frames}


def _staged_f32():
    """bench.py:272-368's staged replay (float32, map capacity 32) on the
    12-car world cut to chip_smoke.OBJ_FRAMES frames, run without x64: its
    map size and ATE."""
    import jax
    import jax.numpy as jnp

    from objects_world import jax_config, jax_initial_state
    from orcvio_tpu.dataio.synthetic import generate
    from orcvio_tpu.eval import object_map_sim as jsim
    from orcvio_tpu.objects.staged import ObjectsStream, make_objects_replay
    from orcvio_tpu.vio import VioState

    import chip_smoke as cs

    dtype = jnp.float32
    wc = jsim.WorldConfig(n_frames=cs.OBJ_FRAMES)
    sim, ocfg = jax_config(wc)
    data = generate(sim, R_b2c=np.asarray([[0., -1, 0], [0, 0, -1], [1, 0, 0]],
                                          np.float32),
                    t_c_b=np.asarray([0.05, 0.02, 0.0], np.float32))
    gt_R, gt_p = np.asarray(data.gt_R), np.asarray(data.gt_p)
    objs = jsim.make_world(wc)
    rng = np.random.default_rng(wc.seed + 1)
    dets = []
    R_b2c = np.asarray([[0., -1, 0], [0, 0, -1], [1, 0, 0]])
    for k in range(wc.n_frames):
        wTc = np.eye(4)
        wTc[:3, :3] = gt_R[k] @ R_b2c.T
        wTc[:3, 3] = gt_p[k] + gt_R[k] @ np.asarray([0.05, 0.02, 0.0])
        dets.append(jsim.analytic_detections(wc, objs, wTc, rng)[:5])
    stream = ObjectsStream(*(jnp.asarray(np.stack(x).astype(
        np.float32) if np.stack(x).dtype.kind == "f" else np.stack(x))
        for x in zip(*dets)))
    vs = VioState.create(ocfg.filter, sim.max_obs, dtype)
    vs = vs.replace(filter=jax_initial_state(ocfg.filter, sim, dtype))
    replay = make_objects_replay(ocfg, sim.max_obs, map_capacity=32,
                                 dtype=dtype)
    frames = jax.tree.map(
        lambda x: x.astype(dtype) if x.dtype.kind == "f" else x, data.frames)
    t0 = time.perf_counter()
    carry, outs = jax.jit(replay)(replay.init_carry(vs), frames, stream)
    jax.block_until_ready(outs)
    secs = time.perf_counter() - t0
    est_p = np.asarray(outs["p"])
    return {"n_map": int(np.asarray(carry.omap.valid).sum()),
            "ate_m": float(np.sqrt(np.mean(np.sum((est_p - gt_p) ** 2, 1)))),
            "cpu_seconds_with_compile": secs}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--jax-staged-f32" in sys.argv:
        print(json.dumps(_staged_f32()))
        sys.exit(0)
    if "--jax-object-map" not in sys.argv:
        sys.exit("usage: python tests/test_torch_objects_e2e.py "
                 "--jax-object-map")
    jax.config.update("jax_enable_x64", True)
    out = {"config_a": {"update": _config_a(True),
                        "no_update": _config_a(False)}}
    staged = subprocess.run([sys.executable, __file__, "--jax-staged-f32"],
                            capture_output=True, text=True, check=True)
    out["staged_f32"] = json.loads(staged.stdout.strip().splitlines()[-1])
    print(json.dumps(out))
