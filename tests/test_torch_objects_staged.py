"""The staged object replay (make_objects_replay), the port against the
JAX package.

Config A's world (tests/objects_world.py) cut to 2 x HALF frames,
min_frames 8 and a 16-frame window, float64 on the CPU, finalize budget 1.
The JAX replay runs the two halves in turn (one compile); the port runs
all frames from the same start, and once more from the JAX carry after
the first half (``convert.objects_carry_from_numpy``). Per frame the map
size is identical and the position within 1e-6 m; the final maps agree
(poses within 1e-6 m); at least one object update was applied (the port's
decisions are read through a spy on ``object_ekf_update``).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

HALF = 12
CUTS = dict(min_frames=8, window=16, pose_history=128)
TOL_M = 1e-6
MAP_CAPACITY = 16


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from objects_world import port_tensor, world
    from orcvio_tpu.filter.pipeline import FrameInput as JaxFrameInput
    from orcvio_tpu.objects.staged import ObjectsStream as JaxStream
    from orcvio_tpu.objects.staged import make_objects_replay as jax_replay
    from orcvio_tpu.vio import VioState as JaxVioState
    from orcvio_tpu_torch.convert import (objects_carry_from_numpy,
                                          state_to_numpy, vio_state_from_numpy)
    from orcvio_tpu_torch.filter.pipeline import FrameInput
    from orcvio_tpu_torch.objects import staged
    from orcvio_tpu_torch.objects.staged import (ObjectsStream,
                                                 make_objects_replay)

    torch.set_num_threads(1)
    w = world(2 * HALF, **CUTS)
    jv = JaxVioState.create(w["jcfg"].filter, w["sim"].max_obs, jnp.float64)
    jv = jv.replace(filter=w["jstate"])
    jrep = jax_replay(w["jcfg"], w["sim"].max_obs, map_capacity=MAP_CAPACITY,
                      dtype=jnp.float64)
    jrun = jax.jit(jrep)

    def half(xs, h, cls):
        return cls(*(jnp.asarray(x[h * HALF:(h + 1) * HALF]) for x in xs))

    c0 = jrep.init_carry(jv)
    c1, o1 = jrun(c0, half(w["frames"], 0, JaxFrameInput),
                  half(w["dets"], 0, JaxStream))
    c2, o2 = jrun(c1, half(w["frames"], 1, JaxFrameInput),
                  half(w["dets"], 1, JaxStream))
    jax_out = {k: np.concatenate([np.asarray(o1[k]), np.asarray(o2[k])])
               for k in o1}

    used = []
    update = staged.object_ekf_update

    def spy(*a, **kw):
        out = update(*a, **kw)
        used.append(bool(out[1]))
        return out

    staged.object_ekf_update = spy
    try:
        prep = make_objects_replay(w["pcfg"], w["sim"].max_obs,
                                   map_capacity=MAP_CAPACITY,
                                   dtype=torch.float64, device="cpu")
        frames = FrameInput(*(port_tensor(x) for x in w["frames"]))
        stream = ObjectsStream(*(port_tensor(x) for x in w["dets"]))
        pv = vio_state_from_numpy(state_to_numpy(jv), torch.float64, "cpu")
        pc, pout = prep(prep.init_carry(pv), frames, stream)
        n_used = sum(used)
        # onward from the JAX carry after the first half
        mid = objects_carry_from_numpy(state_to_numpy(c1), torch.float64,
                                       "cpu")
        pc2, pout2 = prep(mid, FrameInput(*(x[HALF:] for x in frames)),
                          ObjectsStream(*(x[HALF:] for x in stream)))
    finally:
        staged.object_ekf_update = update
    return dict(jax_out=jax_out, jax_map=c2.omap, port_out=pout,
                port_map=pc.omap, n_used=n_used, mid_out=pout2,
                mid_map=pc2.omap)


def test_map_size_per_frame(runs):
    np.testing.assert_array_equal(runs["port_out"]["n_map"].numpy(),
                                  runs["jax_out"]["n_map"])
    assert runs["jax_out"]["n_map"][-1] >= 1


def test_trajectory_within_1e6_m(runs):
    err = np.abs(runs["port_out"]["p"].numpy() - runs["jax_out"]["p"]).max()
    assert err < TOL_M, err


def test_an_object_update_was_applied(runs):
    assert runs["n_used"] >= 1


def _same_map(pm, jm):
    valid = np.asarray(jm.valid)
    np.testing.assert_array_equal(pm.valid.numpy(), valid)
    for f in ("class_id", "n_obs", "n_tracks"):
        np.testing.assert_array_equal(getattr(pm, f).numpy()[valid],
                                      np.asarray(getattr(jm, f))[valid])
    for f in ("wTo", "shape", "kps_world"):
        np.testing.assert_allclose(getattr(pm, f).numpy()[valid],
                                   np.asarray(getattr(jm, f))[valid],
                                   atol=TOL_M)


def test_final_map_within_1e6_m(runs):
    _same_map(runs["port_map"], runs["jax_map"])


def test_onward_from_the_jax_carry(runs):
    """The port continues the JAX replay's second half from its carry."""
    err = np.abs(runs["mid_out"]["p"].numpy()
                 - runs["jax_out"]["p"][HALF:]).max()
    assert err < TOL_M, err
    np.testing.assert_array_equal(runs["mid_out"]["n_map"].numpy(),
                                  runs["jax_out"]["n_map"][HALF:])
    _same_map(runs["mid_map"], runs["jax_map"])
