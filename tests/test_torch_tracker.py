"""The front-end slice as a whole: the port's tracker against the JAX package's.

8 frames of a translated smooth texture at 120x160 with gyro-aided
prediction, capacity 32, 2 pyramid levels, a 4x4 detection grid, detection
every 2nd frame, float64 on the CPU. The port runs with KLT_EPS = 0 (the
JAX CPU path's fixed-count LK) and with JAX's exact RANSAC Gumbel draws
injected frame by frame. Track ids, masks and descriptors are identical;
coordinates and velocities agree within 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from orcvio_tpu.eval.staged import make_tracker_scan as jax_make_scan
from orcvio_tpu.eval.staged import stage_sequence as jax_stage
from orcvio_tpu.frontend import tracker as jtr
from orcvio_tpu_torch.convert import tracker_state_from_numpy
from orcvio_tpu_torch.eval.staged import make_tracker_scan, stage_sequence
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.frontend import tracker as ptr

torch.set_num_threads(1)

T, H, W, N = 8, 120, 160, 32
CFG = dict(height=H, width=W, capacity=N, pyramid_levels=2, grid_rows=4,
           grid_cols=4, detect_every=2)
R_B2C = Rotation.from_rotvec([0.02, -0.01, 0.03]).as_matrix()
TOL = 1e-9


def _sequence(seed=0, shift=(2.6, -1.7)):
    """uint8 frames of a periodic smooth texture shifted by `shift` px per
    frame, 20 Hz timestamps and small-gyro IMU slabs."""
    rng = np.random.default_rng(seed)
    F = np.fft.fft2(rng.normal(size=(H, W)))
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.fftfreq(W)[None, :]
    F = F * np.exp(-(kx**2 + ky**2) * (2 * np.pi * 2.0) ** 2 / 2)
    frames = np.stack([np.real(np.fft.ifft2(F * np.exp(
        -2j * np.pi * (kx * shift[0] * k + ky * shift[1] * k))))
        for k in range(T)])
    frames = (frames - frames.min()) / (frames.max() - frames.min())
    images = np.round(frames * 235.0 + 10.0).astype(np.uint8)
    S = 4
    t = 1.0 + 0.05 * np.arange(T)
    imu_t = t[:, None] - 0.05 + 0.0125 * np.arange(1, S + 1)[None, :]
    gyro = rng.normal(size=(T, S, 3)) * 0.05
    acc = np.zeros((T, S, 3))
    mask = np.ones((T, S), bool)
    mask[3, 2:] = False
    return images, t, imu_t, gyro, acc, mask


def _gumbels(key, steps):
    """JAX's RANSAC noise for `steps` frames from tracker key `key`, split
    as process_frame splits it."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (128, 8, N),
                                                jnp.float64)))
    return torch.as_tensor(np.stack(out))


def _state_dict(ts):
    return {"pyr": [np.asarray(ai.padded) for ai in ts.pyr],
            "xy": np.asarray(ts.xy), "uvn": np.asarray(ts.uvn),
            "desc": np.asarray(ts.desc), "fid": np.asarray(ts.fid),
            "t": np.asarray(ts.t), "next_id": np.asarray(ts.next_id)}


@pytest.fixture(scope="module")
def seq():
    return _sequence()


@pytest.fixture(scope="module")
def jax_steps(seq):
    """JAX process_frame frame by frame: per-frame outputs and states."""
    images, t, _, gyro, _, mask = seq
    tc = jtr.TrackerConfig(**CFG)
    step = jax.jit(jtr.process_frame, static_argnums=0)
    ts = jtr.TrackerState.create(tc, jnp.float64)
    outs, states, keys = [], [], []
    for k in range(T):
        keys.append(ts.rng)
        mg = (gyro[k] * mask[k][:, None]).sum(0) / max(mask[k].sum(), 1)
        ts, out = step(tc, ts, jnp.asarray(images[k], jnp.float64),
                       jnp.float64(t[k]), jnp.asarray(mg),
                       jnp.asarray(R_B2C), jnp.int32(k))
        outs.append(jax.tree_util.tree_map(np.asarray, out))
        states.append(_state_dict(ts))
    return outs, states, keys


@pytest.fixture
def fixed_count_lk(monkeypatch):
    monkeypatch.setattr(pklt, "KLT_EPS", 0.0)


def _assert_frames_match(ours, fids, uvs, vels):
    np.testing.assert_array_equal(ours.fids.numpy(), fids)
    np.testing.assert_array_equal(ours.meas_mask.numpy(), fids >= 0)
    np.testing.assert_allclose(ours.uvs.numpy(), uvs, rtol=0, atol=TOL)
    np.testing.assert_allclose(ours.uv_vels.numpy(), vels, rtol=0, atol=TOL)


def test_scan_matches_jax(seq, fixed_count_lk):
    tc = jtr.TrackerConfig(**CFG)
    ts0 = jtr.TrackerState.create(tc, jnp.float64)
    jts, jfr = jax.jit(jax_make_scan(tc, R_B2C, jnp.float64))(
        ts0, jax_stage(*seq, jnp.float64))
    scan = make_tracker_scan(ptr.TrackerConfig(**CFG), R_B2C, torch.float64,
                             device="cpu")
    pts, pfr = scan(ptr.TrackerState.create(ptr.TrackerConfig(**CFG),
                                            torch.float64, device="cpu"),
                    stage_sequence(*seq, torch.float64, device="cpu"),
                    ransac_gumbel=_gumbels(ts0.rng, T))
    fids = np.asarray(jfr.fids)
    _assert_frames_match(pfr, fids, np.asarray(jfr.uvs),
                         np.asarray(jfr.uv_vels))
    # the sequence exercises losses and re-detections, not only tracking
    assert (fids < 0).any() and fids.max() >= N
    np.testing.assert_array_equal(pts.desc.numpy().astype(np.uint32),
                                  np.asarray(jts.desc))
    assert int(pts.next_id) == int(jts.next_id)


def test_frame_steps_match_jax(seq, jax_steps, fixed_count_lk):
    images, t, _, gyro, _, mask = seq
    outs, states, keys = jax_steps
    tc = ptr.TrackerConfig(**CFG)
    ts = ptr.TrackerState.create(tc, torch.float64, device="cpu")
    R = torch.as_tensor(R_B2C)
    for k in range(T):
        mg = (gyro[k] * mask[k][:, None]).sum(0) / max(mask[k].sum(), 1)
        ts, out = ptr.process_frame(
            tc, ts, torch.as_tensor(images[k], dtype=torch.float64),
            torch.tensor(t[k]), torch.as_tensor(mg), R, frame_idx=k,
            ransac_gumbel=_gumbels(keys[k], 1)[0])
        _assert_frames_match(out, outs[k].fids, outs[k].uvs, outs[k].uv_vels)
        np.testing.assert_array_equal(ts.desc.numpy().astype(np.uint32),
                                      states[k]["desc"])
        np.testing.assert_allclose(ts.xy.numpy(), states[k]["xy"], rtol=0,
                                   atol=TOL)


def test_convert_round_trip(seq, jax_steps, fixed_count_lk):
    """Start the port from the JAX state after frame 4; match frames 5-8."""
    outs, states, keys = jax_steps
    tc = ptr.TrackerConfig(**CFG)
    ts4 = tracker_state_from_numpy(states[3], tc, torch.float64, device="cpu")
    assert ts4.desc.dtype == torch.int64 and ts4.fid.dtype == torch.int32
    scan = make_tracker_scan(tc, R_B2C, torch.float64, device="cpu")
    tail = stage_sequence(*(x[4:] for x in seq), torch.float64, device="cpu")
    ts, frames = scan(ts4, tail, ransac_gumbel=_gumbels(keys[4], T - 4))
    _assert_frames_match(
        frames, np.stack([o.fids for o in outs[4:]]),
        np.stack([o.uvs for o in outs[4:]]),
        np.stack([o.uv_vels for o in outs[4:]]))
    np.testing.assert_array_equal(ts.desc.numpy().astype(np.uint32),
                                  states[-1]["desc"])
    for ours, theirs in zip(ts.pyr, states[-1]["pyr"]):
        np.testing.assert_allclose(ours.padded.numpy(), theirs, rtol=0,
                                   atol=TOL)
