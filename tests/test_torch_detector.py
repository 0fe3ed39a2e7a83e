"""The StarMap keypoint detector: the port (orcvio_tpu_torch/objects/
detector.py) against the JAX package's (orcvio_tpu/objects/detector.py)
on the CPU.

* The crop resize: the port's two products with jax.image.resize's
  weights against ``jax.image.resize(..., "linear")`` (antialiased where
  it downsamples), upscaling, downscaling and non-square, within 1e-6 in
  float32 and 1e-12 in float64.
* The yaw templates (36 yaws x 2 elevations rendered by the numpy
  renderer), bit for bit.
* The whole detector on 3 of config B's renders, frame after frame so
  that the temporal prior carries: each call's keypoints (normalized
  coordinates) within 1e-5 of JAX's float32 ones, the masks and the
  chosen templates equal (tests/test_torch_starmap_e2e.py holds it over
  15 more frames).
* The geometric assignment on the same peaks, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.dataio.render_object import CAR_KEYPOINTS
from orcvio_tpu.objects import detector as jdet
from orcvio_tpu_torch.objects import detector as pdet
from starmap_world import config_b_frames, jax_pretrained

torch.set_num_threads(2)
FRAMES = (4, 5, 90)  # two cars; from 4 to 5 the template prior carries


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)],
                         ids=["float32", "float64"])
def test_resize_matches_jax_image_resize(dtype, tol):
    rng = np.random.default_rng(0)
    det = pdet.StarMapKeypointDetector.__new__(pdet.StarMapKeypointDetector)
    det.size, det._weights = 96, {}
    for h, w in [(40, 50), (150, 130), (30, 200), (97, 95), (96, 41),
                 (210, 96), (61, 61)]:
        p = rng.uniform(0, 1, (h, w)).astype(dtype)
        j = np.asarray(jax.image.resize(jnp.asarray(p), (96, 96), "linear"))
        got = det.resize(torch.as_tensor(p)).numpy()
        assert got.dtype == dtype
        np.testing.assert_allclose(got, j, rtol=0, atol=tol,
                                   err_msg=f"{h}x{w}")


@pytest.fixture(scope="module")
def detectors(monkeypatch_module):
    """Both packages' detectors on config B's camera (the JAX package's
    checkpoint read without its eager init, tests/starmap_world.py)."""
    import orcvio_tpu.models.starmap as js

    monkeypatch_module.setattr(js, "load_pretrained",
                               lambda path=None: jax_pretrained())
    from orcvio_tpu_torch.eval.object_map_cnn import camera_K

    K = camera_K()
    return (jdet.StarMapKeypointDetector(CAR_KEYPOINTS, K),
            pdet.StarMapKeypointDetector(CAR_KEYPOINTS, K, device="cpu"))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_yaw_templates_bit_for_bit(detectors):
    jd, pd = detectors
    for a, b in zip(jd._proj_templates, pd._proj_templates):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(pd._proj_templates[0]) == 72


def test_detector_on_config_b_renders(detectors):
    jd, pd = detectors
    imgs, boxes, valid, *_ = config_b_frames(max(FRAMES) + 1)
    n_found = 0
    for k in FRAMES:
        assert valid[k].sum() == 1
        jk, jm = jd(imgs[k] * 255.0, boxes[k], valid[k])
        pk, pm = pd(imgs[k] * 255.0, boxes[k], valid[k])
        assert pk.dtype == np.float32 and pk.shape == jk.shape == (4, 12, 2)
        assert np.array_equal(pm, jm), k
        np.testing.assert_allclose(pk, jk, rtol=0, atol=1e-5,
                                   err_msg=f"frame {k}")
        # the chosen template and the box it is remembered by
        assert np.array_equal(pd._prev_tmpl, jd._prev_tmpl), k
        assert np.array_equal(pd._prev_boxes, jd._prev_boxes), k
        n_found += int(pm.sum())
    assert n_found >= 3 * len(FRAMES)


def test_geometric_assignment_exact(detectors):
    """_assign_geometric on the same peaks, with and without a prior,
    gives the same labels and template."""
    jd, pd = detectors
    rng = np.random.default_rng(3)
    tmpl = pd._proj_templates[0][17]
    labelled = 0
    for prior in (-1, 17, 40):
        for trial in range(4):
            n = 16
            xy = np.concatenate([tmpl[:8] * 10 + 2 + rng.normal(0, 0.3, (8, 2)),
                                 rng.uniform(0, 24, (n - 8, 2))])
            val = rng.uniform(size=n) < 0.8
            val[:5] = True
            cvf = rng.normal(size=(n, 3))
            score = rng.uniform(0.3, 1.0, n)
            bb = np.array([2.0, 2.0, 12.0, 12.0])
            a = jd._assign_geometric(xy, val, cvf, score, bb, prior)
            b = pd._assign_geometric(xy, val, cvf, score, bb, prior)
            assert (a is None) == (b is None)
            if a is not None:
                assert all(np.array_equal(x, y) for x, y in zip(a, b))
                labelled += 1
    assert labelled >= 6
