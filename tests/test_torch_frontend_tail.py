"""The tail of the port's frontend/image.py against the JAX package's, and
the tracker with CLAHE.

* clahe, equalize_hist's "pwl" mode, gaussian_blur and sample_patch on
  seeded float64 images (a saturated block, values outside [0, 255], odd
  sizes that pad to whole tiles), within 1e-10;
* process_frame with TrackerConfig(equalize="clahe") frame by frame
  against the JAX package's, on tests/test_torch_tracker.py's sequence
  (120x160, float64, KLT_EPS = 0, the JAX package's RANSAC draws
  injected): ids, masks and descriptors identical, coordinates within
  1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.frontend import image as J
from orcvio_tpu.frontend import tracker as jtr
from orcvio_tpu_torch.frontend import image as P
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.frontend import tracker as ptr
from test_torch_tracker import CFG, R_B2C, T, _gumbels, _sequence

torch.set_num_threads(1)

TOL = 1e-10


def _images():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, (61, 83))
    a[5:20, 10:40] = 250.0
    a[30:33, :] = -4.0  # clipped to 0
    b = rng.uniform(-10, 270, (120, 160))
    smooth = np.cumsum(np.cumsum(rng.normal(size=(47, 64)), 0), 1)
    c = (smooth - smooth.min()) / np.ptp(smooth) * 255.0
    return [a, b, c]


@pytest.mark.parametrize("name,kw,k", [
    ("clahe", {}, 0), ("clahe", {}, 2),
    ("clahe", {"grid": (4, 6), "clip_limit": 2.0, "bins": 64}, 2),
    ("equalize_hist", {"mode": "pwl"}, 0),
    ("equalize_hist", {"mode": "pwl"}, 1),
    ("equalize_hist", {"mode": "pwl", "bins": 32, "knots": 8}, 2),
    ("gaussian_blur", {}, 2)], ids=str)
def test_image_function_matches_jax(name, kw, k):
    img = _images()[k]
    ours = getattr(P, name)(torch.as_tensor(img), **kw).numpy()
    theirs = np.asarray(jax.jit(lambda x: getattr(J, name)(x, **kw))(
        jnp.asarray(img)))
    assert ours.shape == img.shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)


def test_sample_patch_matches_jax():
    rng = np.random.default_rng(9)
    img = _images()[2]
    offsets = rng.normal(size=(25, 2)) * 4
    for center in ([30.3, 20.7], [0.2, 0.1], [63.9, 46.5], [-3.0, 50.0]):
        c = np.asarray(center)
        ours = P.sample_patch(torch.as_tensor(img), torch.as_tensor(c),
                              torch.as_tensor(offsets)).numpy()
        theirs = np.asarray(J.sample_patch(jnp.asarray(img), jnp.asarray(c),
                                           jnp.asarray(offsets)))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)


def test_unknown_equalize_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        P.equalize_hist(torch.zeros(8, 8), mode="exact")


def test_clahe_tracker_matches_jax(monkeypatch):
    monkeypatch.setattr(pklt, "KLT_EPS", 0.0)
    images, t, _, gyro, _, mask = _sequence()
    jtc = jtr.TrackerConfig(**CFG, equalize="clahe")
    ptc = ptr.TrackerConfig(**CFG, equalize="clahe")
    step = jax.jit(jtr.process_frame, static_argnums=0)
    jts = jtr.TrackerState.create(jtc, jnp.float64)
    pts = ptr.TrackerState.create(ptc, torch.float64, device="cpu")
    R = torch.as_tensor(R_B2C)
    for k in range(T):
        key = jts.rng
        mg = (gyro[k] * mask[k][:, None]).sum(0) / max(mask[k].sum(), 1)
        jts, jout = step(jtc, jts, jnp.asarray(images[k], jnp.float64),
                         jnp.float64(t[k]), jnp.asarray(mg),
                         jnp.asarray(R_B2C), jnp.int32(k))
        pts, pout = ptr.process_frame(
            ptc, pts, torch.as_tensor(images[k], dtype=torch.float64),
            torch.tensor(t[k]), torch.as_tensor(mg), R, frame_idx=k,
            ransac_gumbel=_gumbels(key, 1)[0])
        fids = np.asarray(jout.fids)
        np.testing.assert_array_equal(pout.fids.numpy(), fids)
        np.testing.assert_array_equal(pout.meas_mask.numpy(), fids >= 0)
        np.testing.assert_allclose(pout.uvs.numpy(), np.asarray(jout.uvs),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(pout.uv_vels.numpy(),
                                   np.asarray(jout.uv_vels), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(pts.desc.numpy().astype(np.uint32),
                                      np.asarray(jts.desc))
    assert (fids >= 0).sum() > 10
    # CLAHE changes what is tracked: the equalized levels differ
    poly = ptr.TrackerConfig(**CFG)
    assert poly.equalize is True and ptc.equalize == "clahe"
    img = torch.as_tensor(images[0], dtype=torch.float64)
    assert not torch.allclose(P.clahe(img), P.equalize_hist(img))
