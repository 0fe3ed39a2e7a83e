"""Kernel K3 (fixed-count LK over a given template) and its path
(``_template``, ``_lk_iterate_pallas``, ``track_level``, ``pyr_track``)
against the JAX package, on the CPU.

* K3's plain version against the TPU kernel lk_iterate_fused(...,
  interpret=True) in float32: the TPU kernel selects pixels through a hi/lo
  bf16 split (~2^-8 gray), so positions agree within 1e-3 px (as
  tests/test_lk_pallas.py holds the kernel against _lk_iterate), residuals
  within 1e-2, convergence flags on >= 95% of features.
* The port's _template + _lk_iterate_pallas against JAX _template +
  _lk_iterate in float64: positions and residuals within 1e-9, identical
  flags (the two differ only in the order of float64 roundings).
* track_level and pyr_track (KLT_EPS = 0) against the JAX ones on a whole
  smooth frame in float64: positions within 1e-9, identical flags.
* forward_backward_track and pyr_track take raw level tensors as well as
  prepared ones, with the same result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.frontend import klt as jklt
from orcvio_tpu.frontend.image import build_pyramid
from orcvio_tpu.ops import lk_pallas as jlk
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.ops import lk_pallas as plk
from tests.test_frontend import shift_image, smooth_texture
from tests.test_torch_lk import _make_case

torch.set_num_threads(1)

PATCH = 15
ITERS = 10


def _lws(case, jto, pto):
    """(win0, win1) LevelWindows of the case, for JAX then for the port."""
    win0, win1, origin, start = case[:4]
    return tuple(mod(win=to(w), origin=to(origin), start=to(start))
                 for mod, to in ((jklt.LevelWindows, jto),
                                 (pklt.LevelWindows, pto))
                 for w in (win0, win1))


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("n", [1, 5, 33, 64, 65])
def test_plain_matches_tpu_kernel(n, lanes):
    case = _make_case(n, seed=n, lanes=lanes)
    xy0 = case[4]
    p_init = (xy0 + np.random.default_rng(n).uniform(-1, 1, xy0.shape)
              ).astype(np.float32)
    jlw0, _, _, plw1 = _lws(case, jnp.asarray, torch.as_tensor)
    tmpl = jax.jit(jklt._template, static_argnums=(2, 3))(
        jlw0, jnp.asarray(xy0), PATCH, "f32x2")
    tmpl_t = tuple(torch.tensor(np.asarray(x)) for x in tmpl)
    aux, lo, hi = pklt._iterate_aux(plw1, tmpl_t, torch.as_tensor(p_init),
                                    PATCH)
    ours = plk.lk_iterate_fused(plw1.win, *tmpl_t[:3], aux, ITERS,
                                PATCH).numpy()
    block_n = 64 if lanes <= 128 else 32  # as _lk_iterate_pallas picks it
    tpu = np.asarray(jlk.lk_iterate_fused(
        jnp.asarray(case[1]), *tmpl[:3], jnp.asarray(aux.numpy()), ITERS,
        PATCH, pklt.SEARCH_WD, block_n=block_n, interpret=True))
    assert ours.shape == tpu.shape == (n, 8)
    assert np.abs(ours[:, :2] - tpu[:, :2]).max() < 1e-3
    assert np.abs(ours[:, 2] - tpu[:, 2]).max() < 1e-2
    det = np.asarray(tmpl[6])
    conv = [pklt._converged(torch.tensor(o[:, :2]), torch.tensor(o[:, 3]),
                            torch.tensor(det), lo, hi).numpy()
            for o in (ours, tpu)]
    assert (conv[0] == conv[1]).mean() >= 0.95
    np.testing.assert_array_equal(ours[:, 4:], 0.0)
    np.testing.assert_array_equal(tpu[:, 4:], 0.0)


@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("n,seed", [(64, 0), (33, 3)])
def test_iterate_path_matches_jax_cpu_path(n, seed, lanes):
    case = _make_case(n, seed=seed, lanes=lanes)
    xy0, shifts = case[4], case[5]
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    t64 = lambda x: torch.tensor(np.asarray(x, np.float64))  # noqa: E731
    jlw0, jlw1, plw0, plw1 = _lws(case, f64, t64)
    tmpl_j = jax.jit(jklt._template, static_argnums=(2, 3))(
        jlw0, f64(xy0), PATCH, "f32x2")
    p_ref, res_ref, conv_ref = jax.jit(
        jklt._lk_iterate, static_argnums=(3, 4, 5))(
        jlw1, tmpl_j, f64(xy0), PATCH, ITERS, "f32x2")
    tmpl = pklt._template(plw0, t64(xy0), PATCH)
    for a, b in zip(tmpl, tmpl_j):  # the Hessian terms reach 1e6
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-9)
    p, res, conv = pklt._lk_iterate_pallas(plw1, tmpl, t64(xy0), PATCH, ITERS)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    for a, b in zip(pklt._lk_iterate(plw1, tmpl, t64(xy0), PATCH, ITERS),
                    (p, res, conv)):
        assert torch.equal(a, b)
    flow_err = np.linalg.norm(p.numpy() - xy0 + shifts, axis=1)
    assert conv.numpy().mean() > 0.8
    assert np.median(flow_err[conv.numpy()]) < 0.25


def _frame_pair(shift=(2.5, -1.5), seed=12, n=25):
    """A smooth 120x160 frame and its shift by `shift` px in float64, and n
    positions inside (tests/test_window_gather.py's full-frame case)."""
    img0 = jnp.asarray(smooth_texture(120, 160, seed=seed), jnp.float64)
    img1 = shift_image(img0, jnp.asarray(shift, jnp.float64))
    xy0 = np.random.default_rng(seed).uniform([20, 20], [140, 100],
                                              size=(n, 2))
    return np.array(img0), np.array(img1), xy0


def test_track_level_matches_jax():
    img0, img1, xy0 = _frame_pair()
    p_ref, res_ref, conv_ref = jax.jit(
        jklt.track_level, static_argnums=(4, 5, 6))(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(xy0),
        jnp.asarray(xy0), PATCH, ITERS, 0.01)
    t = torch.as_tensor
    p, res, conv = pklt.track_level(t(img0), t(img1), t(xy0), t(xy0), PATCH,
                                    ITERS, 0.01)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert conv.numpy().sum() >= 20
    flow = (p.numpy() - xy0)[conv.numpy()]
    assert np.allclose(np.median(flow, axis=0), (2.5, -1.5), atol=0.05)
    empty = pklt.track_level(t(img0), t(img1), t(xy0[:0]), t(xy0[:0]), PATCH,
                             ITERS, 0.01)
    assert [tuple(x.shape) for x in empty] == [(0, 2), (0,), (0,)]


@pytest.mark.parametrize("shift", [(2.5, -1.5), (7.5, -5.25)])
def test_pyr_track_matches_jax(monkeypatch, shift):
    img0, img1, xy0 = _frame_pair(shift, seed=1, n=30)
    pyr0, pyr1 = ([np.array(x) for x in build_pyramid(jnp.asarray(i), 3)]
                  for i in (img0, img1))
    ref = jax.jit(jklt.pyr_track, static_argnums=(4, 5))(
        pyr0, pyr1, jnp.asarray(xy0), jnp.asarray(xy0), PATCH, ITERS)
    monkeypatch.setattr(pklt, "KLT_EPS", 0.0)
    t = torch.as_tensor
    res = pklt.pyr_track([t(x) for x in pyr0], [t(x) for x in pyr1], t(xy0),
                         t(xy0), patch=PATCH, iters=ITERS)
    np.testing.assert_allclose(res.xy.numpy(), np.asarray(ref.xy), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(ref.ok))
    assert res.ok.numpy().sum() > 20
    prepared = pklt.pyr_track(pklt.prepare_pyramid([t(x) for x in pyr0]),
                              pklt.prepare_pyramid([t(x) for x in pyr1]),
                              t(xy0), t(xy0), patch=PATCH, iters=ITERS)
    assert torch.equal(prepared.xy, res.xy) and torch.equal(prepared.ok,
                                                            res.ok)


def test_forward_backward_track_takes_raw_levels():
    img0, img1, xy0 = _frame_pair(seed=5, n=30)
    t = torch.as_tensor
    pyr0, pyr1 = ([t(np.array(x)) for x in build_pyramid(jnp.asarray(i), 3)]
                  for i in (img0, img1))
    raw = pklt.forward_backward_track(pyr0, pyr1, t(xy0), t(xy0))
    prep = pklt.forward_backward_track(pklt.prepare_pyramid(pyr0),
                                       pklt.prepare_pyramid(pyr1), t(xy0),
                                       t(xy0))
    assert torch.equal(raw.xy, prep.xy) and torch.equal(raw.ok, prep.ok)
    assert raw.ok.numpy().sum() > 20
