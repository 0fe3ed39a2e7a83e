"""Kernel K2's plain version (one fused LK level) against the JAX package.

* At eps = 0 the plain version is the fixed-count loop: it must equal the
  JAX CPU path (_template + _lk_iterate) in float64, positions and
  residuals within 1e-9 and identical convergence flags.
* Against the TPU kernel lk_level_fused(..., block_n=1, interpret=True) in
  float32: the TPU kernel selects pixels through a hi/lo bf16 split
  (~2^-8 gray), so positions agree within 1e-2 px at eps = 0 (as
  tests/test_lk_pallas.py holds the kernel), and within 2e-2 px at
  eps = 0.01, where the split error may move a feature's stop by one step
  of at most eps; convergence flags agree on >= 95% of features.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from orcvio_tpu.frontend.klt import (
    ROWS, LANES, SEARCH_WD, LevelWindows, _lk_iterate, _template, resample,
)
from orcvio_tpu.ops import lk_pallas as jlk
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.ops import lk_pallas as plk
from orcvio_tpu_torch.ops.lk_pallas import AUX_W, lk_level_fused

torch.set_num_threads(1)

PATCH = 15
ITERS = 10


def _make_case(n, shift_scale=3.0, seed=0, lanes=LANES):
    """Smooth windows + per-feature true shifts, the shapes gather_level
    produces (tests/test_lk_pallas.py's case): win (N, ROWS, lanes) float32
    with the logical search window starting at `start` inside it."""
    rng = np.random.default_rng(seed)
    H, W = 256, 384
    base = rng.normal(size=(H // 8, W // 8))
    img = np.kron(base, np.ones((8, 8)))
    img = (gaussian_filter(img, 3.0) * 400.0 + 128.0).astype(np.float32)
    shifts = rng.uniform(-shift_scale, shift_scale, size=(n, 2)).astype(
        np.float32)
    cx = rng.uniform(80, W - 80, size=n).astype(np.float32)
    cy = rng.uniform(80, H - 80, size=n).astype(np.float32)
    t0 = -(SEARCH_WD // 2)
    win0 = np.zeros((n, ROWS, lanes), np.float32)
    win1 = np.zeros((n, ROWS, lanes), np.float32)
    origin = np.zeros((n, 2), np.float32)
    start = np.zeros((n, 2), np.float32)
    yy, xx = np.mgrid[0:ROWS, 0:lanes]
    for i in range(n):
        ox = np.floor(cx[i]) + t0 - 8  # origin 8 px left of the logical start
        oy = np.floor(cy[i]) + t0
        origin[i] = (ox, oy)
        start[i] = (np.floor(cx[i]) + t0, np.floor(cy[i]) + t0)
        gy = np.clip(yy + int(oy), 0, H - 1)
        gx = np.clip(xx + int(ox), 0, W - 1)
        win0[i] = img[gy, gx]
        sx, sy = shifts[i]
        fy, fx_ = np.floor(sy), np.floor(sx)
        ay, ax_ = sy - fy, sx - fx_
        g2y = np.clip(yy + int(oy) + int(fy), 0, H - 2)
        g2x = np.clip(xx + int(ox) + int(fx_), 0, W - 2)
        win1[i] = ((1 - ay) * (1 - ax_) * img[g2y, g2x]
                   + (1 - ay) * ax_ * img[g2y, g2x + 1]
                   + ay * (1 - ax_) * img[g2y + 1, g2x]
                   + ay * ax_ * img[g2y + 1, g2x + 1])
    xy0 = np.stack([cx, cy], axis=1)
    return win0, win1, origin, start, xy0, shifts


@pytest.mark.parametrize("P", [15, 17, 33])
def test_resample_equals_jax_cpu_branch(P):
    """The port's one bilinear sampler (K2's plain version and ORB's patch
    reads) is bit-identical to the JAX package's CPU branch in float64,
    corners clamped at both window edges included."""
    rng = np.random.default_rng(P)
    n, R, L = 24, 48, 2 * LANES
    win = rng.uniform(0.0, 255.0, size=(n, R, L))
    local = np.stack([rng.uniform(-3.0, L - P + 2.0, n),
                      rng.uniform(-3.0, R - P + 2.0, n)], axis=1)
    ref = np.asarray(resample(jnp.asarray(win)[None], jnp.asarray(local),
                              P))[0]
    ours = plk.resample(torch.tensor(win), torch.tensor(local[:, 0]),
                        torch.tensor(local[:, 1]), P).numpy()
    assert ours.shape == (n, P, P)
    np.testing.assert_array_equal(ours, ref)
    assert pklt.resample is plk.resample


def _lw(mod, win, origin, start, to):
    return mod(win=to(win), origin=to(origin), start=to(start))


@pytest.mark.parametrize("n,seed", [(64, 0), (33, 3)])
def test_plain_eps0_matches_jax_cpu_path(monkeypatch, n, seed):
    win0, win1, origin, start, xy0, shifts = _make_case(n, seed=seed)
    f64 = lambda x: jnp.asarray(x, jnp.float64)  # noqa: E731
    t64 = lambda x: torch.tensor(np.asarray(x, np.float64))  # noqa: E731
    lw0 = _lw(LevelWindows, win0, origin, start, f64)
    lw1 = _lw(LevelWindows, win1, origin, start, f64)
    tmpl = jax.jit(_template, static_argnums=(2, 3))(lw0, f64(xy0), PATCH,
                                                     "f32x2")
    p_ref, res_ref, conv_ref = jax.jit(_lk_iterate, static_argnums=(3, 4, 5))(
        lw1, tmpl, f64(xy0), PATCH, ITERS, "f32x2")
    monkeypatch.setattr(pklt, "KLT_EPS", 0.0)
    p, res, conv = pklt._lk_level(
        _lw(pklt.LevelWindows, win0, origin, start, t64),
        _lw(pklt.LevelWindows, win1, origin, start, t64),
        t64(xy0), t64(xy0), PATCH, ITERS)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    flow_err = np.linalg.norm(p.numpy() - xy0 + shifts, axis=1)
    assert conv.numpy().mean() > 0.8
    assert np.median(flow_err[conv.numpy()]) < 0.25


def _aux(origin, start, xy0, rng):
    """K2 inputs as klt._level_aux builds them, from a perturbed start."""
    r = (PATCH - 1) // 2
    lo = start - origin + r
    hi = lo + (SEARCH_WD - 2 * r - 1.001)
    aux = np.zeros((len(xy0), AUX_W), np.float32)
    aux[:, 0:2] = xy0 - origin
    aux[:, 4:6] = lo
    aux[:, 6:8] = hi
    aux[:, 10:12] = xy0 - origin + rng.uniform(-1, 1, size=xy0.shape)
    return aux, lo, hi


def _conv(out, lo, hi):
    lxy = out[:, :2]
    interior = ((lxy > lo + 1e-3) & (lxy < hi - 1e-3)).all(axis=1)
    return (out[:, 4] > 1e-6) & (out[:, 3] < 1.0) & interior


@pytest.mark.parametrize("eps,tol", [(0.0, 1e-2), (0.01, 2e-2)])
def test_plain_matches_tpu_kernel(eps, tol):
    win0, win1, origin, start, xy0, _ = _make_case(48, seed=11)
    aux, lo, hi = _aux(origin, start, xy0, np.random.default_rng(12))
    ours = lk_level_fused(torch.as_tensor(win0), torch.as_tensor(win1),
                          torch.as_tensor(aux), ITERS, PATCH, eps).numpy()
    tpu = np.asarray(jlk.lk_level_fused(
        jnp.asarray(win0), jnp.asarray(win1), jnp.asarray(aux), ITERS, PATCH,
        SEARCH_WD, block_n=1, interpret=True, eps=eps))
    assert ours.shape == tpu.shape == (48, 8)
    assert np.abs(ours[:, :2] - tpu[:, :2]).max() < tol
    assert np.abs(ours[:, 4] - tpu[:, 4]).max() < 1e-3 * np.abs(tpu[:, 4]).max()
    assert (_conv(ours, lo, hi) == _conv(tpu, lo, hi)).mean() >= 0.95
    steps = ours[:, 5]
    assert ((steps >= 1) & (steps <= ITERS)).all()
    assert (steps == ITERS).all() if eps == 0.0 else (steps < ITERS).any()
    np.testing.assert_array_equal(ours[:, 6:], 0.0)
