"""The port's front-end building blocks against the JAX package's, on the CPU.

Same numpy inputs through both; JAX in float64 (tests/conftest.py turns on
x64), the port with device="cpu" in float64. Float outputs agree within
1e-9; bits, indices and masks are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.frontend import detect as jdetect
from orcvio_tpu.frontend import image as jimage
from orcvio_tpu.frontend import orb as jorb
from orcvio_tpu.frontend import ransac as jransac
from orcvio_tpu.frontend import undistort as jund
from orcvio_tpu.math import so3 as jso3
from orcvio_tpu_torch.frontend import detect as pdetect
from orcvio_tpu_torch.frontend import image as pimage
from orcvio_tpu_torch.frontend import orb as porb
from orcvio_tpu_torch.frontend import ransac as pransac
from orcvio_tpu_torch.frontend import undistort as pund
from orcvio_tpu_torch.math import so3 as pso3

torch.set_num_threads(1)
TOL = 1e-9


def _j(x):
    return jnp.asarray(x, jnp.float64)


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _texture(H, W, seed, sigma=2.0):
    """Smooth random texture in [10, 245], float64."""
    rng = np.random.default_rng(seed)
    F = np.fft.fft2(rng.normal(size=(H, W)))
    ky = np.fft.fftfreq(H)[:, None]
    kx = np.fft.fftfreq(W)[None, :]
    img = np.real(np.fft.ifft2(
        F * np.exp(-(kx**2 + ky**2) * (2 * np.pi * sigma) ** 2 / 2)))
    return (img - img.min()) / (img.max() - img.min()) * 235.0 + 10.0


def test_so3_exp():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(size=(20, 3)),
                        rng.normal(size=(5, 3)) * 1e-7, np.zeros((1, 3))])
    np.testing.assert_allclose(pso3.exp(_t(w)).numpy(),
                               np.asarray(jax.jit(jso3.exp)(_j(w))),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(pso3.hat(_t(w)).numpy(),
                               np.asarray(jso3.hat(_j(w))), rtol=0, atol=0)


@pytest.mark.parametrize("model,coeffs", [
    ("radtan", (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)),
    ("equidistant", (-0.013, 0.0022, -0.0017, 0.0003)),
    ("none", ()),
])
def test_undistort(model, coeffs):
    rng = np.random.default_rng(1)
    K = (458.654, 457.296, 367.215, 248.375)
    uv = rng.uniform([0, 0], [752, 480], size=(64, 2))
    a = pund.undistort_pixels(_t(uv), K, model, coeffs).numpy()
    b = np.asarray(jund.undistort_pixels(_j(uv), K, model, coeffs))
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_allclose(pund.normalized_to_pixel(_t(a), K).numpy(),
                               np.asarray(jund.normalized_to_pixel(_j(a), K)),
                               rtol=0, atol=TOL)
    if model == "radtan":
        xy = rng.normal(size=(16, 2)) * 0.3
        np.testing.assert_allclose(
            pund.distort_radtan(_t(xy), *coeffs).numpy(),
            np.asarray(jund.distort_radtan(_j(xy), *coeffs)), rtol=0, atol=TOL)
    if model == "equidistant":
        xy = rng.normal(size=(16, 2)) * 0.3
        np.testing.assert_allclose(
            pund.distort_equidistant(_t(xy), *coeffs).numpy(),
            np.asarray(jund.distort_equidistant(_j(xy), *coeffs)),
            rtol=0, atol=TOL)


def test_equalize_hist():
    img = _texture(120, 160, seed=2) * 0.6 + 30.0  # low contrast
    a = pimage.equalize_hist(_t(img)).numpy()
    b = np.asarray(jax.jit(jimage.equalize_hist)(_j(img)))
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(120, 160), (121, 157)])
def test_pyramid_and_gradients(shape):
    img = _texture(*shape, seed=3)
    pa = pimage.build_pyramid(_t(img), 3)
    pb = jimage.build_pyramid(_j(img), 3)
    for a, b in zip(pa, pb):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    for a, b in zip(pimage.gradients(_t(img)), jimage.gradients(_j(img))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


def test_shi_tomasi_score():
    img = _texture(120, 160, seed=4)
    np.testing.assert_allclose(pdetect.shi_tomasi_score(_t(img)).numpy(),
                               np.asarray(jdetect.shi_tomasi_score(_j(img))),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("occupied", [False, True])
def test_detect_grid(occupied):
    img = _texture(120, 160, seed=5)
    rng = np.random.default_rng(6)
    kw = {}
    if occupied:
        xy = rng.uniform([0, 0], [160, 120], size=(24, 2))
        mask = rng.uniform(size=24) < 0.7
        kw_t = dict(occupied_xy=_t(xy), occupied_mask=torch.as_tensor(mask))
        kw_j = dict(occupied_xy=_j(xy), occupied_mask=jnp.asarray(mask))
    else:
        kw_t = kw_j = kw
    xa, sa, va = pdetect.detect_grid(_t(img), 3, 4, 4, min_distance=12.0,
                                     **kw_t)
    xb, sb, vb = jax.jit(
        lambda im, **k: jdetect.detect_grid(im, 3, 4, 4, min_distance=12.0,
                                            **k))(_j(img), **kw_j)
    va, vb = va.numpy(), np.asarray(vb)
    assert va.sum() > 10
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(xa.numpy()[va], np.asarray(xb)[vb])
    np.testing.assert_allclose(sa.numpy()[va], np.asarray(sb)[vb], rtol=0,
                               atol=TOL)


def test_orb_pattern_and_describe():
    np.testing.assert_array_equal(porb.make_pattern().numpy(),
                                  np.asarray(jorb.make_pattern()))
    img = _texture(120, 160, seed=7)
    rng = np.random.default_rng(8)
    # interior, border, and outside-the-image keypoints
    xy = np.concatenate([rng.uniform([0, 0], [160, 120], size=(40, 2)),
                         [[-5.5, 60.2], [170.3, 20.1], [80.7, -3.0]]])
    a = porb.describe(_t(img), _t(xy)).numpy()
    b = np.asarray(jax.jit(jorb.describe)(_j(img), _j(xy)))
    assert a.dtype == np.int64 and (a >= 0).all() and (a < 2**32).all()
    np.testing.assert_array_equal(a.astype(np.uint32), b)
    np.testing.assert_allclose(
        porb.orientation(_t(img), _t(xy)).numpy(),
        np.asarray(jax.jit(jorb.orientation)(_j(img), _j(xy))),
        rtol=0, atol=TOL)


def test_hamming():
    rng = np.random.default_rng(9)
    d1 = rng.integers(0, 2**32, size=(50, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2**32, size=(50, 8), dtype=np.uint64).astype(np.uint32)
    d2[:5] = d1[:5]
    a = porb.hamming(torch.as_tensor(d1.astype(np.int64)),
                     torch.as_tensor(d2.astype(np.int64))).numpy()
    b = np.asarray(jorb.hamming(jnp.asarray(d1), jnp.asarray(d2)))
    np.testing.assert_array_equal(a, b)
    assert (a[:5] == 0).all()


@pytest.mark.parametrize("n_valid", [60, 8])
def test_ransac_with_injected_gumbel(n_valid):
    rng = np.random.default_rng(10)
    N = 80
    p1 = rng.uniform(-0.5, 0.5, size=(N, 2))
    depth = rng.uniform(2.0, 6.0, size=N)
    t = np.array([0.1, 0.02, 0.01])
    X = np.concatenate([p1 * depth[:, None], depth[:, None]], axis=1) - t
    p2 = X[:, :2] / X[:, 2:3]
    p2[::7] += rng.normal(size=p2[::7].shape) * 0.05  # outliers
    valid = np.zeros(N, bool)
    valid[rng.permutation(N)[:n_valid]] = True
    key = jax.random.PRNGKey(3)
    gumbel = np.asarray(jax.random.gumbel(key, (128, 8, N), jnp.float64))
    # the injected noise reproduces JAX's categorical draw exactly
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits[None, :], shape=(128, 8))
    np.testing.assert_array_equal(np.argmax(gumbel + np.asarray(logits), -1),
                                  np.asarray(idx))
    inl_a, F_a = pransac.ransac_fundamental(_t(p1), _t(p2),
                                            torch.as_tensor(valid),
                                            gumbel=_t(gumbel))
    inl_b, F_b = jax.jit(jransac.ransac_fundamental)(
        _j(p1), _j(p2), jnp.asarray(valid), key)
    np.testing.assert_array_equal(inl_a.numpy(), np.asarray(inl_b))
    np.testing.assert_allclose(F_a.numpy(), np.asarray(F_b), rtol=0, atol=TOL)
    if n_valid >= 12:
        assert 0 < inl_a.numpy().sum() < n_valid
