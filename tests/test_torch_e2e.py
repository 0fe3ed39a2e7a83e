"""The slice as a whole: the port's make_e2e_replay against the JAX package's.

The stream is chip_smoke.py's end-to-end stream (the EuRoC writer's
make_stream: the bench trajectory, IMU noise and biases, ground-plane
texture and image noise), cut to 40 frames with a 0.5 s static start and
seen by a 160x120 camera. Static init needs
5 static frames; the filter runs the frames after it at small capacities
(8 clones, 48 feature rows, 6 one-dof EKF features) with the bench flags.
Both packages run in float64 on the CPU, the port with KLT_EPS = 0 and the
JAX package's RANSAC Gumbel draws injected. Init falls on the same frame,
update counts and ZUPT flags are identical, and p agrees within 1e-6 m.

Also the port's smooth_texture and render_plane_view against the JAX
package's.

Run as a script, ``python tests/test_torch_e2e.py --jax-bench-ate``, it runs
the JAX package's replay over chip_smoke.py's full end-to-end stream (the
port writer's frames and IMU, made on the CPU; float32, as bench.py runs
it) and prints the JAX figures that chip_smoke.py holds the port to.
"""
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from orcvio_tpu.config.core import FilterConfig as JaxFilterConfig
from orcvio_tpu.dataio import synthetic as jsyn
from orcvio_tpu.eval import staged as jstaged
from orcvio_tpu.frontend.tracker import TrackerConfig as JaxTrackerConfig
from orcvio_tpu.frontend.tracker import TrackerState as JaxTrackerState
from orcvio_tpu.vio import VioState as JaxVioState
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.dataio import euroc_writer as pwriter
from orcvio_tpu_torch.dataio import synthetic as psyn
from orcvio_tpu_torch.eval.staged import make_e2e_replay, stage_sequence
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState
from orcvio_tpu_torch.vio import VioState

H, W, N = 120, 160, 32
K_SMALL = (100.0, 100.0, 80.0, 60.0)
T = 40
SIM = {**cs.BENCH_SIM, "static_time": 0.5, "ramp_time": 1.0}
TRACKER = {**cs.TRACKER, "height": H, "width": W, "capacity": N,
           "pyramid_levels": 2, "grid_rows": 4, "grid_cols": 4, "K": K_SMALL}
FILTER = {**cs.BENCH_FILTER, "sw_size": 8, "max_features": 48,
          "max_update_features": 8, "ekf_feature_cap": 6,
          "static_image_num": 5, "static_min_matches": 10}
P_TOL = 1e-6

torch.set_num_threads(1)


def init_frame(R):
    """The frame static init ends on: the first output pose that is not the
    identity the filter starts from."""
    moved = np.abs(np.asarray(R) - np.eye(3)).reshape(len(R), -1).max(1) > 0
    return int(np.argmax(moved)) if moved.any() else None


def _gumbels(key, steps):
    """JAX's RANSAC noise for `steps` frames from tracker key `key`,
    split as process_frame splits it."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (128, 8, N),
                                                jnp.float64)))
    return torch.as_tensor(np.stack(out))


WC = pwriter.WriterConfig(cam=pwriter.CameraModel(W, H, *K_SMALL))


@pytest.fixture(scope="module")
def stream():
    sim = psyn.SimConfig(n_frames=T, **SIM)
    return cs.bench_inputs(pwriter.make_stream(sim, WC, device="cpu"))


@pytest.fixture(scope="module")
def runs(stream):
    inputs = stream
    R_b2c, t_c_b = pwriter.R_B2C_DOWN, np.asarray(WC.t_c_b)
    jtc = JaxTrackerConfig(**TRACKER)
    jcfg = JaxFilterConfig(**FILTER)
    jts0 = JaxTrackerState.create(jtc, jnp.float64)
    jvs0 = JaxVioState.create(jcfg, N, jnp.float64)
    replay = jax.jit(jstaged.make_e2e_replay(jcfg, jtc, R_b2c, t_c_b,
                                             jnp.float64))
    _, jouts = replay(jts0, jvs0,
                      jstaged.stage_sequence(*inputs, jnp.float64))
    jouts = {k: np.asarray(v) for k, v in jouts.items()}

    mp = pytest.MonkeyPatch()
    mp.setattr(pklt, "KLT_EPS", 0.0)
    try:
        tc, cfg = TrackerConfig(**TRACKER), FilterConfig(**FILTER)
        preplay = make_e2e_replay(cfg, tc, R_b2c, t_c_b, torch.float64,
                                  device="cpu")
        (_, vs), pouts = preplay(
            TrackerState.create(tc, torch.float64, device="cpu"),
            VioState.create(cfg, N, torch.float64, device="cpu"),
            stage_sequence(*inputs, torch.float64, device="cpu"),
            ransac_gumbel=_gumbels(jts0.rng, T))
    finally:
        mp.undo()
    return jouts, {k: v.numpy() for k, v in pouts.items()}, vs


def test_init_on_the_same_frame(runs):
    jouts, pouts, vs = runs
    k0 = init_frame(jouts["R"])
    assert k0 is not None and 5 <= k0 < T - 20, k0
    assert init_frame(pouts["R"]) == k0
    np.testing.assert_array_equal(pouts["initialized"],
                                  np.arange(T) >= k0)
    assert vs.host_initialized


@pytest.mark.parametrize("field", ["n_upd", "zupt"])
def test_decisions_identical(runs, field):
    jouts, pouts, _ = runs
    np.testing.assert_array_equal(pouts[field], jouts[field])
    if field == "n_upd":
        assert jouts["n_upd"].sum() > 0


@pytest.mark.parametrize("field", ["p", "R", "v"])
def test_pose_matches(runs, field):
    jouts, pouts, _ = runs
    err = np.abs(pouts[field] - jouts[field]).reshape(T, -1).max(1)
    assert err.max() < P_TOL, (int(err.argmax()), float(err.max()))


def test_smooth_texture_matches_jax():
    ours = psyn.smooth_texture(256, 320, seed=4, device="cpu").numpy()
    theirs = np.asarray(jsyn.smooth_texture(256, 320, seed=4))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("t", [0.3, 2.0, 4.5])
def test_render_plane_view_matches_jax(t):
    """A pose of the bench trajectory; float32 throughout, as the
    stream is rendered."""
    sim = psyn.SimConfig(n_frames=T, **SIM)
    R, p = psyn.trajectory_pose_np(sim, t)
    R_c2w = (R @ pwriter.R_B2C_DOWN.T).astype(np.float32)
    t_cw = (p + R @ np.asarray(WC.t_c_b)).astype(np.float32)
    tex = psyn.smooth_texture(512, 512, seed=4, device="cpu")
    ours = psyn.render_plane_view(tex, 0.05, torch.as_tensor(R_c2w),
                                  torch.as_tensor(t_cw), K_SMALL, H, W)
    theirs = jsyn.render_plane_view(jnp.asarray(tex.numpy()), 0.05,
                                    jnp.asarray(R_c2w), jnp.asarray(t_cw),
                                    K_SMALL, H, W)
    theirs = np.asarray(theirs)
    assert (theirs > 0).mean() > 0.9
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-3)


def jax_bench_ate(n):
    """The JAX package's replay over chip_smoke.py's end-to-end stream
    (the port's make_stream on the CPU: the frames and IMU phase 5 replays)
    in float32 on the CPU: init frame, update count, ATE (posyaw, all
    frames)."""
    jax.config.update("jax_platforms", "cpu")
    from orcvio_tpu.config.core import FilterConfig
    from orcvio_tpu.eval.staged import make_e2e_replay, stage_sequence
    from orcvio_tpu.eval.trajectory import ate
    from orcvio_tpu.frontend.tracker import TrackerConfig, TrackerState
    from orcvio_tpu.math import quat
    from orcvio_tpu.vio import VioState

    wc = pwriter.WriterConfig()
    t0 = time.perf_counter()
    st = pwriter.make_stream(psyn.SimConfig(n_frames=n, **cs.BENCH_SIM), wc,
                             device="cpu")
    images, ft, it, ig, ia, im = cs.bench_inputs(st)
    stream_s = time.perf_counter() - t0

    tc = TrackerConfig(**cs.TRACKER, K=wc.cam.K)
    cfg = FilterConfig(**cs.BENCH_FILTER)
    replay = jax.jit(make_e2e_replay(cfg, tc, pwriter.R_B2C_DOWN,
                                     np.asarray(wc.t_c_b), jnp.float32))
    t0 = time.perf_counter()
    _, outs = replay(TrackerState.create(tc, jnp.float32),
                     VioState.create(cfg, tc.capacity, jnp.float32),
                     stage_sequence(images, ft, it, ig, ia, im, jnp.float32))
    outs = {k: np.asarray(v) for k, v in outs.items()}
    replay_s = time.perf_counter() - t0
    from_rot = jax.vmap(quat.from_rotation)
    m = ate(ft, outs["p"], np.asarray(from_rot(jnp.asarray(outs["R"]))),
            ft, st.gt_p, np.asarray(from_rot(jnp.asarray(st.gt_R))),
            alignment="posyaw")
    k0 = init_frame(outs["R"])
    return {"frames": n, "init_frame": k0,
            "filter_frames": None if k0 is None else n - 1 - k0,
            "n_upd_total": int(outs["n_upd"].sum()),
            "zupt_frames": int(outs["zupt"].sum()),
            "ate_m": m["rmse_trans"], "ate_rot_deg": m["rmse_rot_deg"],
            "finite": bool(np.isfinite(outs["p"]).all()),
            "stream_s": stream_s, "compile_and_replay_s": replay_s,
            "dtype": "float32", "platform": "cpu"}


if __name__ == "__main__":
    if "--jax-bench-ate" not in sys.argv:
        sys.exit("usage: python tests/test_torch_e2e.py --jax-bench-ate")
    print(json.dumps(jax_bench_ate(cs.E2E_FRAMES)))
