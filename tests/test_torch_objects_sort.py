"""Kf4, Kf7, IoU, the auction and SORT: the port against the JAX package
in float64 on the CPU.

The filters and the IoU agree within 1e-9; the auction's assignments and
SORT's ids, classes, hits, ages and lost flags are identical, frame by
frame, over config A's detection stream (tests/objects_world.py), boxes
within 1e-9.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.objects import kf as jkf
from orcvio_tpu.objects import sort as jsort
from orcvio_tpu_torch.convert import sort_state_from_numpy, state_to_numpy
from orcvio_tpu_torch.objects import kf as pkf
from orcvio_tpu_torch.objects import sort as psort

sys.path.insert(0, str(Path(__file__).resolve().parent))
torch.set_num_threads(1)
TOL = 1e-9


def t(x):
    return torch.as_tensor(np.array(x))


def close(p, j, tol=TOL):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=tol)


def test_kf4_sequence():
    rng = np.random.default_rng(1)
    batch = (3, 12)
    js = jkf.kf4_create(batch, jnp.float64)
    ps = pkf.kf4_create(batch, torch.float64)
    step = jax.jit(jkf.kf4_step)
    for k in range(6):
        z = rng.normal(size=batch + (2,)) * 0.1 + 0.01 * k
        tk = np.full(batch, 0.05 * (k + 1))
        valid = rng.uniform(size=batch) > 0.3
        js = step(js, jnp.asarray(z), jnp.asarray(tk), jnp.asarray(valid))
        ps = pkf.kf4_step(ps, t(z), t(tk), t(valid))
        for f in ("x", "P", "t"):
            close(getattr(ps, f), getattr(js, f))
        np.testing.assert_array_equal(ps.init.numpy(), np.asarray(js.init))


def test_kf7_and_box_maps():
    rng = np.random.default_rng(2)
    lo = rng.uniform(-1, 0.5, size=(10, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.05, 0.5, size=(10, 2))], 1)
    close(pkf.bbox_to_z(t(box)), jkf.bbox_to_z(jnp.asarray(box)))
    z = np.asarray(jkf.bbox_to_z(jnp.asarray(box)))
    close(pkf.z_to_bbox(t(z)), jkf.z_to_bbox(jnp.asarray(z)))
    js = jkf.kf7_predict(jkf.kf7_init(jnp.asarray(box), jnp.float64))
    ps = pkf.kf7_predict(pkf.kf7_init(t(box)))
    box2 = box + rng.normal(size=box.shape) * 0.02
    valid = rng.uniform(size=10) > 0.3
    js = jkf.kf7_update(js, jnp.asarray(box2), jnp.asarray(valid))
    ps = pkf.kf7_update(ps, t(box2), t(valid))
    close(ps.x, js.x)
    close(ps.P, js.P)


def test_iou_matrix():
    rng = np.random.default_rng(3)
    lo = rng.uniform(-1, 0.5, size=(14, 2))
    box = np.concatenate([lo, lo + rng.uniform(0.05, 0.8, size=(14, 2))], 1)
    close(psort.iou_matrix(t(box[:9]), t(box[5:])),
          jsort.iou_matrix(jnp.asarray(box[:9]), jnp.asarray(box[5:])))


@pytest.mark.parametrize("seed,quantized", [(4, False), (5, True), (6, True)])
def test_auction_assign(seed, quantized):
    """Random benefits, and benefits on a coarse grid, so that bids tie
    (the lowest row wins in both)."""
    rng = np.random.default_rng(seed)
    N, M = 12, 8
    b = rng.uniform(size=(N, M))
    if quantized:
        b = np.round(b * 4) / 4
    vr = rng.uniform(size=N) > 0.2
    vc = rng.uniform(size=M) > 0.2
    j = jax.jit(jsort.auction_assign)(jnp.asarray(b), jnp.asarray(vr),
                                      jnp.asarray(vc))
    p = psort.auction_assign(t(b), t(vr), t(vc))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_sort_sequence():
    """SORT over config A's first 60 detection frames, and onward from the
    JAX state after frame 30 (``convert.sort_state_from_numpy``)."""
    from objects_world import jax_config, port_config
    from orcvio_tpu.eval import object_map_sim as jsim
    from orcvio_tpu_torch.dataio import synthetic as psyn
    from orcvio_tpu_torch.eval import object_map_sim as psim

    wc = psim.WorldConfig(n_frames=60)
    data = psyn.generate(psim.world_sim(wc), R_b2c=psim.R_B2C,
                         t_c_b=psim.T_C_B, dtype=torch.float64, device="cpu")
    dets = psim.detection_stream(wc, psim.make_world(wc), data.gt_R.numpy(),
                                 data.gt_p.numpy(),
                                 np.random.default_rng(wc.seed + 1))
    jsc = jax_config(jsim.WorldConfig(n_frames=60))[1].sort
    psc = port_config(wc).sort
    js = jsort.SortState.create(jsc, jnp.float64)
    ps = psort.SortState.create(psc, torch.float64)
    step = jax.jit(lambda s, b, c, v: jsort.sort_step(jsc, s, b, c, v))
    lost = 0
    for k in range(60):
        boxes, classes, _, _, valid = (x[k] for x in dets)
        js, jo = step(js, jnp.asarray(boxes), jnp.asarray(classes),
                      jnp.asarray(valid))
        ps, po = psort.sort_step(psc, ps, t(boxes), t(classes), t(valid))
        for f in ("track_id", "class_id", "reported", "lost", "lost_id"):
            np.testing.assert_array_equal(getattr(po, f).numpy(),
                                          np.asarray(getattr(jo, f)), f)
        close(po.bboxes, jo.bboxes)
        for f in ("hits", "age", "frames", "next_id"):
            np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        lost += int(po.lost.sum())
        if k == 30:
            ps = sort_state_from_numpy(state_to_numpy(js), torch.float64,
                                       "cpu")
    assert lost >= 1 and int(ps.next_id) >= 4
