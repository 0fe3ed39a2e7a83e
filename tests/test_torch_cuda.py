"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and nvcc, is marked ``cuda`` and skips
where there is none. The file imports neither JAX nor the JAX package, so
it runs on a machine with PyTorch alone (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K4 (``csrc/cov_update.cu``): within the rounding bound of two length-q
sums (``k4_tolerance``, entry by entry, the same as chip_smoke.py's), in
float32 and float64, at ragged and main-path shapes and the object
update's (D = 82, q = 1260), on both sides of q = 32, where the small kernel hands over to the tiled one; exactly
symmetric, whatever the shape; D = 0 gives an empty output. Its nb
entry (Schmidt) keeps P[nb:, nb:] bit for bit, nb on and off the 32-row
tile, on both kernels.

K1 (``csrc/window_gather.cu``): bit-exact against the plain version.

The vmap rules (K1, K2's level route, K4): a batch of B calls under
``torch.func.vmap`` is one launch, and each row equals its own single
launch bit for bit, with operands batched, shared (in_dim None) and
shared through a batch stride of 0.

K2 (``csrc/lk_level.cu``): positions within 1e-3 px of the plain version
at eps = 0 and 2e-2 px at eps = 0.01 (both exact float32 taps; the sums
differ in order, which may move a stop by one step), convergence agreeing
on >= 99 %; the level route (``lk_level_src``, reading the padded levels
in place) bit-identical to the window route; on either route a feature
whose search bounds exceed the kernel's tile gets a NaN row, the others
their own.

K3 (``csrc/lk_level.cu``, K2's kernel body with the template given):
positions and residuals within 1e-3 of the plain version (both exact
float32 taps; the sums differ in order), columns 4-7 exactly 0, at
L = 128 and 256, at P = 15, 21 and 31 (each of the kernel's three
instantiations); the level route (``lk_iterate_src``) bit-identical to the
window route; a NaN row where the search bounds exceed the tile or the
window lies outside its source; exactly `iters` steps, a NaN step
included. K5 (``csrc/extract64.cu``): bit-exact, windows and offsets.

K6 (``csrc/triangulate.cu``): a batch of triangulations under
``torch.func.vmap`` is one launch; valid and anchor_slot identical to the
plain version's (both compute in float64, for float32 tensors too), at
the fleet cell's shape and the object path's (T = 32, with a prior
point); on noise-free tracks the valid features' positions within 1e-12
(float64) and 1e-5 (float32) relative, on noisy ones within 10 sqrt(u) in
float64, where the Levenberg-Marquardt loop's accept decisions may differ
by the two versions' rounding of the cost; after 1, 2 and 3 steps on
tracks with outliers past the Huber threshold, every feature's cost at
the two answers within 1e-9, and after 1 and 2 steps x within 1e-10;
at a static start's baseline, float32 tensors within 1e-5 of the float64
answer where float32 arithmetic is 1e-4 or more off it.

The StarMap network (no kernel of ours: cuDNN convolutions, as the JAX
package's are XLA's) in float32 on the card against its float64 CPU run.
"""
import numpy as np
import pytest
import torch

from orcvio_tpu_torch.frontend import klt
from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain
from orcvio_tpu_torch.ops.dma_gather import (dma_gather_tiles,
                                             dma_gather_tiles_plain)
from orcvio_tpu_torch.ops.lk_pallas import (SEARCH_TILE, lk_iterate_fused,
                                            lk_iterate_fused_plain,
                                            lk_iterate_src, lk_level_fused,
                                            lk_level_fused_plain,
                                            lk_level_src)
from orcvio_tpu_torch.ops.window_gather import (prepare_image,
                                                window_origins)
from orcvio_tpu_torch.scripts import race_extract as race

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(D, q, seed, dtype, device):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    return tuple(torch.as_tensor(x, dtype=dtype, device=device) for x in (
        A @ A.T / D, rng.normal(size=(D, q)) * 0.1,
        rng.normal(size=(q, D)) * 0.1))


def k4_tolerance(P, K, HP, out):
    """Per-element bound on |kernel - plain| for sym(P - K HP): each forms
    A(r, c) and A(c, r) as length-q sums in its own order, so each is off
    the exact value by at most gamma_{q+2} (|K| |HP| + |P|) entry by entry
    (gamma_n = n u / (1 - n u)), plus a rounding of the mean; the two
    outputs differ by at most twice that."""
    u = torch.finfo(P.dtype).eps / 2
    n = K.shape[1] + 2
    g = n * u / (1 - n * u)
    M = K.double().abs() @ HP.double().abs() + P.double().abs()
    return 2 * (g * 0.5 * (M + M.T) + u * out.double().abs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [1, 9, 32, 33, 384, 444, 1000])
@pytest.mark.parametrize("D", [17, 50, 172, 300])
def test_cov_update_matches_plain(card, dtype, D, q):
    P, K, H = _inputs(D, q, D + q, dtype, card)
    HP = H @ P
    n = cov_update.launches
    out = cov_update(P, K, H, HP)
    torch.cuda.synchronize()
    assert cov_update.launches == n + 1
    assert torch.equal(out, out.T)
    ref = cov_update_plain(P, K, H, HP)
    err = (out - ref).abs().double()
    assert bool((err <= k4_tolerance(P, K, HP, ref)).all())
    assert torch.equal(cov_update(P, K, H), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,q,nb", [
    (196, 444, 160), (208, 444, 172), (232, 444, 196), (208, 9, 172),
    (232, 9, 196), (50, 33, 0), (50, 9, 17), (172, 444, 172)])
def test_cov_update_nb_keeps_the_block(card, dtype, D, q, nb):
    """The nb entry (Schmidt): P[nb:, nb:] kept bit for bit, in tiles
    wholly inside the block and in those that straddle nb, on both
    kernels (q <= 32 and above); the rest as the plain version."""
    P, K, H = _inputs(D, q, D + q + nb, dtype, card)
    HP = H @ P
    n = cov_update.launches
    out = cov_update(P, K, H, HP, nb)
    torch.cuda.synchronize()
    assert cov_update.launches == n + 1
    assert torch.equal(out, out.T)
    assert torch.equal(out[nb:, nb:], P[nb:, nb:])
    ref = cov_update_plain(P, K, H, HP, nb)
    err = (out - ref).abs().double()
    assert bool((err <= k4_tolerance(P, K, HP, ref)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cov_update_at_the_object_update_shape(card, dtype):
    """The object-residual update's shape: D = 82 (config A's ten clones),
    q = 45 x (2 x 12 + 4) = 1260 stacked rows."""
    D, q = 82, 1260
    P, K, H = _inputs(D, q, 7, dtype, card)
    HP = H @ P
    n = cov_update.launches
    out = cov_update(P, K, H, HP)
    torch.cuda.synchronize()
    assert cov_update.launches == n + 1
    assert torch.equal(out, out.T)
    ref = cov_update_plain(P, K, H, HP)
    err = (out - ref).abs().double()
    assert bool((err <= k4_tolerance(P, K, HP, ref)).all())


def test_cov_update_empty(card):
    P, K, H = _inputs(0, 5, 0, torch.float32, card)
    assert tuple(cov_update(P, K, H).shape) == (0, 0)


def test_cov_update_rejects_what_it_cannot_take(card):
    P, K, H = _inputs(20, 8, 0, torch.float32, card)
    with pytest.raises(ValueError):
        cov_update(P, K.double(), H)
    with pytest.raises(TypeError):
        cov_update(P.half(), K.half(), H.half())


def _frame_pair(device, seed=0):
    """A smooth 240x320 frame and its shift by (1.7, -0.9) px, float32."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.normal(size=(31, 41)), np.ones((8, 8)))
    k = np.ones(9) / 9.0
    for ax in (0, 1):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base)
    img = base * 60.0 + 128.0
    yy, xx = np.mgrid[0:240, 0:320]
    sx, sy = 1.7, -0.9
    x0, y0 = xx - sx + 4, yy - sy + 4
    ix, iy = np.floor(x0).astype(int), np.floor(y0).astype(int)
    fx, fy = x0 - ix, y0 - iy
    img1 = ((1 - fy) * ((1 - fx) * img[iy, ix] + fx * img[iy, ix + 1])
            + fy * ((1 - fx) * img[iy + 1, ix] + fx * img[iy + 1, ix + 1]))
    img0 = img[4:244, 4:324]
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in (img0, img1))


def _k3_case(n, device, seed=0, patch=15):
    """K3's inputs on _frame_pair's frames, as track_level builds them on
    the card: the template from the window of image 0 K1 cuts, and image 1
    both cut (the window route) and located only (the level route)."""
    rng = np.random.default_rng(seed)
    img0, img1 = _frame_pair(device, seed)
    rng.normal(size=(31, 41))  # the draws _frame_pair made
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=device)
    xy = t(rng.uniform([20, 20], [300, 220], size=(n, 2)))
    lw0 = klt.gather_level(prepare_image(img0[None], klt.MARGIN), xy)
    ai1 = prepare_image(img1[None], klt.MARGIN)
    cut = klt.gather_level(ai1, xy)
    src = klt.gather_level(ai1, xy, cut=False)
    tmpl = klt._template(lw0, xy, patch)
    aux, _, _ = klt._iterate_aux(cut, tmpl, xy, patch)
    return cut, src, tmpl[:3], aux


def _k3_both(cut, src, tmpl, aux, patch=15, lanes=256, iters=10,
             plain=True):
    """K3 on the window route and on the level route, and (with `plain`)
    its plain version, which cannot take NaN positions: it indexes by
    them."""
    win = cut.win[:, :, :lanes].contiguous()
    a = lk_iterate_fused(win, *tmpl, aux, iters, patch)
    b = lk_iterate_src(src.level, src.offset, *tmpl, aux, iters, patch,
                       klt.ROWS, lanes)
    torch.cuda.synchronize()
    return a, b, (lk_iterate_fused_plain(win, *tmpl, aux, iters, patch)
                  if plain else None)


def _k2_case(n, device, seed=0):
    """Both routes of one LK level on _k3_case's frame pair: the cut
    windows and the padded levels with the windows' offsets, and aux from
    a start up to 1 px off the true position."""
    rng = np.random.default_rng(seed)
    ai0, ai1 = (prepare_image(im[None], klt.MARGIN)
                for im in _frame_pair(device, seed))
    xy = torch.as_tensor(rng.uniform([20, 20], [300, 220], size=(n, 2)),
                         dtype=torch.float32, device=device)
    p1 = xy + torch.tensor([1.7, -0.9], device=device) + torch.as_tensor(
        rng.uniform(-1, 1, size=(n, 2)), dtype=torch.float32, device=device)
    cut = [klt.gather_level(ai0, xy), klt.gather_level(ai1, p1)]
    src = [klt.gather_level(ai0, xy, cut=False),
           klt.gather_level(ai1, p1, cut=False)]
    aux, lo, hi = klt._level_aux(*cut, xy, p1, 15)
    return cut, src, aux, lo, hi


@pytest.mark.parametrize("eps,tol", [(0.0, 1e-3), (0.01, 2e-2)])
@pytest.mark.parametrize("n", [200, 13, 0])
def test_lk_level_matches_plain_and_routes_agree(card, n, eps, tol):
    (c0, c1), (s0, s1), aux, lo, hi = _k2_case(n, card)
    launches = lk_level_fused.launches
    win = lk_level_fused(c0.win, c1.win, aux, 10, 15, eps)
    lvl = lk_level_src(s0.level, s0.offset, s1.level, s1.offset, aux, 10, 15,
                       eps)
    torch.cuda.synchronize()
    assert lk_level_fused.launches == launches + 2 * (n > 0)
    assert tuple(win.shape) == tuple(lvl.shape) == (n, 8)
    assert torch.equal(win, lvl)
    if n:
        ref = lk_level_fused_plain(c0.win, c1.win, aux, 10, 15, eps)
        assert float((win[:, :2] - ref[:, :2]).abs().max()) < tol
        conv = [klt._converged(o[:, :2], o[:, 3], o[:, 4], lo, hi)
                for o in (win, ref)]
        assert float((conv[0] == conv[1]).float().mean()) >= 0.99
        assert bool((win[:, 6:] == 0).all())
        # the backward pass: template from image 1 at the result, LK over
        # image 0, both routes
        p1 = c1.origin + win[:, :2]
        xy0 = c0.origin + aux[:, 0:2]
        baux = klt._level_aux(c1, c0, p1, xy0, 15)[0]
        bwin = lk_level_fused(c1.win, c0.win, baux, 10, 15, eps)
        blvl = lk_level_src(s1.level, s1.offset, s0.level, s0.offset, baux,
                            10, 15, eps)
        assert torch.equal(bwin, blvl)


@pytest.mark.parametrize("lanes", [250, 256])
def test_lk_level_copies_unaligned_windows(card, lanes):
    """Windows whose rows are not whole 16-byte multiples are staged pixel
    by pixel; the result is the same function."""
    (c0, c1), _, aux, _, _ = _k2_case(40, card, seed=3)
    w0, w1 = (c.win[:, :, :lanes].contiguous() for c in (c0, c1))
    out = lk_level_fused(w0, w1, aux, 10, 15, 0.0)
    ref = lk_level_fused_plain(w0, w1, aux, 10, 15, 0.0)
    torch.cuda.synchronize()
    assert float((out[:, :2] - ref[:, :2]).abs().max()) < 1e-3
    assert torch.equal(out, lk_level_fused(c0.win, c1.win, aux, 10, 15, 0.0))


def test_lk_level_refuses_and_flags_what_its_tile_cannot_hold(card):
    (c0, c1), (s0, s1), aux, _, _ = _k2_case(8, card)
    args = (s0.level, s0.offset, s1.level, s1.offset, aux, 10, 15)
    with pytest.raises(TypeError):
        lk_level_src(s0.level.double(), *args[1:])
    with pytest.raises(ValueError):
        lk_level_src(s0.level, s0.offset.int(), *args[2:])
    wide = aux.clone()
    wide[:3, 6:8] = wide[:3, 4:6] + SEARCH_TILE  # bounds past the tile
    out = lk_level_fused(c0.win, c1.win, wide, 10, 15)
    lvl = lk_level_src(*args[:4], wide, 10, 15)
    ok = lk_level_fused(c0.win, c1.win, aux, 10, 15)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[:3, :5]).all())
    assert torch.equal(out[3:], ok[3:])
    assert torch.equal(lvl[3:], out[3:]) and bool(torch.isnan(lvl[:3, :5]).all())


@pytest.mark.parametrize("n", [200, 440, 13, 0])
def test_window_gather_matches_plain(card, n):
    ai = prepare_image(_frame_pair(card)[0][None], klt.MARGIN)
    xy = torch.as_tensor(np.random.default_rng(n).uniform(
        [-5, -5], [325, 245], size=(n, 2)), dtype=torch.float32, device=card)
    r0, c0, _ = window_origins(ai, xy, -18, 48, 256)
    b = torch.zeros_like(r0)
    launches = dma_gather_tiles.launches
    out = dma_gather_tiles(ai.padded, r0, c0, b, 6, 2)
    torch.cuda.synchronize()
    assert dma_gather_tiles.launches == launches + (n > 0)
    assert tuple(out.shape) == (n, 48, 256)
    assert torch.equal(out, dma_gather_tiles_plain(ai.padded, r0, c0, b, 6, 2))


@pytest.mark.parametrize("lanes", [256, 128])
@pytest.mark.parametrize("n", [200, 65, 64, 33, 5, 1, 0])
def test_lk_iterate_matches_plain(card, n, lanes):
    cut, src, tmpl, aux = _k3_case(n, card)
    launches = lk_iterate_fused.launches
    out, lvl, ref = _k3_both(cut, src, tmpl, aux, lanes=lanes)
    assert lk_iterate_fused.launches == launches + 2 * (n > 0)
    assert tuple(out.shape) == tuple(lvl.shape) == (n, 8)
    assert torch.equal(out, lvl)
    if n:
        assert float((out[:, :2] - ref[:, :2]).abs().max()) < 1e-3
        assert float((out[:, 2] - ref[:, 2]).abs().max()) < 1e-3
        assert bool((out[:, 4:] == 0).all())


@pytest.mark.parametrize("patch", [15, 21, 31])
def test_lk_iterate_each_patch_width(card, patch):
    """P up to 15, 21 and 31 take the kernel's NT = 8, 16 and 32
    instantiations."""
    cut, src, tmpl, aux = _k3_case(40, card, seed=2, patch=patch)
    out, lvl, ref = _k3_both(cut, src, tmpl, aux, patch)
    assert torch.equal(out, lvl)
    assert bool(torch.isfinite(out).all())
    assert float((out[:, :2] - ref[:, :2]).abs().max()) < 1e-3
    assert float((out[:, 2] - ref[:, 2]).abs().max()) < 1e-3


def test_lk_iterate_flags_what_its_tile_cannot_hold(card):
    cut, src, tmpl, aux = _k3_case(8, card)
    ok = _k3_both(cut, src, tmpl, aux)[0]
    wide = aux.clone()
    wide[:3, 6:8] = wide[:3, 4:6] + SEARCH_TILE  # bounds past the tile
    out, lvl, _ = _k3_both(cut, src, tmpl, wide)
    assert bool(torch.isnan(out[:3, :4]).all())
    assert bool((out[:3, 4:] == 0).all())
    assert torch.equal(out[3:], ok[3:])
    assert torch.equal(lvl[3:], out[3:])
    assert bool(torch.isnan(lvl[:3, :4]).all())
    assert bool((lvl[:3, 4:] == 0).all())
    off = src.offset.clone()  # windows outside the level
    off[0] = -1
    off[1] = src.level.numel() - 3
    out = lk_iterate_src(src.level, off, *tmpl, aux, 10, 15)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[:2, :4]).all())
    assert bool((out[:2, 4:] == 0).all()) and torch.equal(out[2:], ok[2:])


def test_lk_iterate_takes_every_step_past_a_nan(card):
    """a11 = NaN makes every y step NaN (a12 = 0 keeps x finite), which
    fminf/fmaxf take to the bound lo_y. The kernel must still take all
    `iters` steps: x moves exactly as with y pinned to lo_y and a finite
    a11 (the plain version can run that), where a stop at the first NaN
    step norm would leave it after one step."""
    cut, src, tmpl, aux = _k3_case(40, card, seed=1)
    aux[:, 1] = 0.0
    aux[:, 11] = aux[:, 5]  # start at y = lo_y
    pinned = aux.clone()
    pinned[:, 7] = pinned[:, 5]  # hi_y = lo_y
    nan = aux.clone()
    nan[:, 0] = float("nan")
    out, lvl, _ = _k3_both(cut, src, tmpl, nan, plain=False)
    ref, _, plain = _k3_both(cut, src, tmpl, pinned)
    one = _k3_both(cut, src, tmpl, nan, iters=1, plain=False)[0]
    nan_col = torch.tensor([False, False, False, True] + [False] * 4,
                           device=card)
    assert bool((torch.isnan(out) == nan_col).all())  # step norms NaN
    assert bool((torch.isnan(lvl) == nan_col).all())
    assert torch.equal(out[:, :3], lvl[:, :3])
    assert torch.equal(out[:, :3], ref[:, :3])
    assert float((out[:, :2] - plain[:, :2]).abs().max()) < 1e-3
    assert bool((out[:, 0] != one[:, 0]).any())


@pytest.mark.parametrize("batch,n", [(1, 200), (8, 200), (2, 13), (3, 0)])
def test_extract64_matches_plain(card, batch, n):
    imgs, oys, oxs = race.draws(frames=batch, seed=batch)
    imgp = race.prep(torch.as_tensor(imgs, device=card))
    oy = torch.as_tensor(oys[:, :n], device=card)
    ox = torch.as_tensor(oxs[:, :n], device=card)
    if n:  # origins at and beyond the edges
        oy[0, :4] = torch.tensor([0, race.HP - race.WD, -7, race.HP])
        ox[0, :4] = torch.tensor([race.WP - 65, 0, race.WP, -9])
    launches = race.extract_pallas.launches
    w, off = race.extract_pallas(imgp, oy, ox)
    torch.cuda.synchronize()
    assert race.extract_pallas.launches == launches + (n > 0)
    w_ref, off_ref = race.extract_dynslice(imgp, oy, ox)
    assert tuple(w.shape) == (batch, n, race.WD, 128)
    assert torch.equal(w, w_ref) and torch.equal(off, off_ref)


def test_lk_iterate_and_extract64_reject_what_they_cannot_take(card):
    cut, src, (t, tgx, tgy), aux = _k3_case(4, card)
    win = cut.win
    with pytest.raises(TypeError):
        lk_iterate_fused(win.double(), t, tgx, tgy, aux, 10, 15)
    with pytest.raises(TypeError):
        lk_iterate_fused(win, t.double(), tgx, tgy, aux, 10, 15)
    with pytest.raises(ValueError):
        lk_iterate_fused(win, t[:, :14, :14].contiguous(), tgx, tgy, aux,
                         10, 15)
    with pytest.raises(ValueError):
        lk_iterate_fused(win, t.transpose(1, 2), tgx, tgy, aux, 10, 15)
    with pytest.raises(TypeError):
        lk_iterate_src(src.level.double(), src.offset, t, tgx, tgy, aux, 10,
                       15)
    with pytest.raises(ValueError):
        lk_iterate_src(src.level, src.offset.int(), t, tgx, tgy, aux, 10, 15)
    with pytest.raises(ValueError):
        lk_iterate_src(src.level, src.offset, t, tgx.transpose(1, 2), tgy,
                       aux, 10, 15)
    with pytest.raises(ValueError):
        lk_iterate_src(src.level.t(), src.offset, t, tgx, tgy, aux, 10, 15)
    imgp = torch.zeros(2, race.HP, race.WP, device=card)
    oy = torch.zeros(2, 5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        race.extract_pallas(imgp, oy.long(), oy)
    with pytest.raises(TypeError):
        race.extract_pallas(imgp.double(), oy, oy)


# --- one filter frame after init captured as a CUDA graph ---
# A frame step that waits on the host (a read-back, or a solver that
# synchronises inside) cannot be captured: torch.cuda.graph raises. The
# stream is the filter parity fixture of tests/test_torch_filter.py (a 1 s
# static start, then motion) from the port's generate, with ZUPT on, so the
# captured frame runs ZUPT's chi-square solve and the EKF updates.
FILTER_CFG = dict(sw_size=8, max_features=48, max_track_len=6, imu_slab=24,
                  max_update_features=8, use_larvio=True,
                  use_left_perturbation=False, use_closed_form_cov_prop=True,
                  if_zupt=True, feature_idp_dim=1, ekf_feature_cap=6,
                  observation_noise=0.004, tri_translation_threshold=-1.0,
                  zupt_max_feature_dis=0.012)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_filter_frame_captures_as_a_cuda_graph(card, dtype):
    from orcvio_tpu_torch.config.core import FilterConfig
    from orcvio_tpu_torch.dataio import synthetic as syn
    from orcvio_tpu_torch.filter import pipeline as pipe
    from orcvio_tpu_torch.filter.state import FilterState

    sim = syn.SimConfig(n_frames=30, n_landmarks=120, max_obs=40,
                        imu_slab=24, seed=3, uv_noise=0.001, static_time=1.0,
                        ramp_time=1.0, fov_limit=0.9)
    R_b2c = np.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    t_c_b = np.asarray([0.05, 0.02, 0.0])
    frames = syn.generate(sim, R_b2c, t_c_b, dtype, device=card).frames
    cfg = FilterConfig(**FILTER_CFG)
    st = FilterState.create(cfg, dtype, device=card)
    R0, p0, v0 = (torch.as_tensor(x).to(card, dtype)
                  for x in syn.initial_state_np(sim))
    imu = st.imu.replace(R=R0, p=p0, v=v0)
    st = st.replace(imu=imu, imu_fej_now=imu, imu_old=imu,
                    R_b2c=torch.as_tensor(R_b2c).to(card, dtype),
                    t_c_b=torch.as_tensor(t_c_b).to(card, dtype),
                    initialized=torch.ones_like(st.initialized))
    chi2 = pipe.build_chi2_table(cfg, dtype, device=card)
    for k in range(25):  # a full window of clones and tracked features
        st, _ = pipe.filter_step(cfg, st, pipe.FrameInput(
            *(x[k] for x in frames)), chi2)
    frame = pipe.FrameInput(*(x[25].clone() for x in frames))
    want_state, want = pipe.filter_step(cfg, st, frame, chi2)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(2):
            pipe.filter_step(cfg, st, frame, chi2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_state, got = pipe.filter_step(cfg, st, frame, chi2)
    graph.replay()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for field in ("p", "R", "v"):
        torch.testing.assert_close(getattr(got, field),
                                   getattr(want, field), rtol=0, atol=tol)
    assert bool(got.zupt == want.zupt)
    assert bool(got.n_update_features == want.n_update_features)
    torch.testing.assert_close(got_state.P, want_state.P, rtol=0,
                               atol=tol * 10)


# --- the vmap rules: a batch in one launch, each row its own launch's bits ---

def _row(x, d, b):
    return x if d is None else x[b]


@pytest.mark.parametrize("shared", ["none", "HP", "P_stride0"])
@pytest.mark.parametrize("q,nb", [(444, 172), (9, 172), (444, 136), (9, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cov_update_batched_rows_equal_single_launches(card, dtype, q, nb,
                                                       shared):
    B, D = 4, 172
    rows = [_inputs(D, q, 100 + b, dtype, card) for b in range(B)]
    P, K = (torch.stack([r[i] for r in rows]) for i in (0, 1))
    HP = torch.stack([r[2] @ r[0] for r in rows])
    dims = [0, 0, 0]
    if shared == "HP":
        HP, dims[2] = HP[0], None
    if shared == "P_stride0":  # as vmap hands back an unbatched output
        P = P[0].expand(B, D, D)
    n = cov_update.launches
    out = torch.func.vmap(lambda p, k, hp: cov_update(p, k, None, hp, nb),
                          in_dims=tuple(dims))(P, K, HP)
    torch.cuda.synchronize()
    assert cov_update.launches == n + 1
    want = torch.stack([cov_update(P[b], K[b], None, _row(HP, dims[2], b), nb)
                        for b in range(B)])
    assert torch.equal(out, want) and torch.equal(out, out.mT)
    assert torch.equal(out[:, nb:, nb:], P[:, nb:, nb:])


@pytest.mark.parametrize("shared", ["none", "img0", "both", "img0_stride0"])
def test_lk_level_src_batched_rows_equal_single_launches(card, shared):
    cases = [_k2_case(200, card, seed=b) for b in range(4)]
    args = [torch.stack(x) for x in zip(*(
        (s0.level, s0.offset, s1.level, s1.offset, aux)
        for _, (s0, s1), aux, _, _ in cases))]
    dims = [0, 0, 0, 0, 0]
    if shared in ("img0", "both"):
        args[0], dims[0] = args[0][0], None
    if shared == "both":
        args[2], dims[2] = args[2][0], None
    if shared == "img0_stride0":
        args[0] = args[0][0].expand_as(args[0])
    n = lk_level_fused.launches
    out = torch.func.vmap(lambda *a: lk_level_src(*a, 10, 15, 0.01),
                          in_dims=tuple(dims))(*args)
    torch.cuda.synchronize()
    assert lk_level_fused.launches == n + 1
    want = torch.stack([lk_level_src(*(_row(x, d, b) for x, d in
                                       zip(args, dims)), 10, 15, 0.01)
                        for b in range(4)])
    assert torch.equal(out, want)


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_window_gather_batched_rows_equal_single_launches(card, shared):
    ais = [prepare_image(_frame_pair(card, seed=b)[0][None], klt.MARGIN)
           for b in range(3)]
    xy = torch.as_tensor(np.random.default_rng(3).uniform(
        [-5, -5], [325, 245], size=(3, 440, 2)), dtype=torch.float32,
        device=card)
    r0, c0 = (torch.stack(x) for x in zip(*(
        window_origins(ais[0], xy[b], -18, 48, 256)[:2] for b in range(3))))
    b0 = torch.zeros_like(r0)
    imgs = ais[0].padded if shared else torch.stack([a.padded for a in ais])
    n = dma_gather_tiles.launches
    out = torch.func.vmap(lambda *a: dma_gather_tiles(*a, 6, 2),
                          in_dims=(None if shared else 0, 0, 0, 0))(
        imgs, r0, c0, b0)
    torch.cuda.synchronize()
    assert dma_gather_tiles.launches == n + 1
    want = torch.stack([dma_gather_tiles(imgs if shared else imgs[b], r0[b],
                                         c0[b], b0[b], 6, 2)
                        for b in range(3)])
    assert torch.equal(out, want)


def test_starmap_network_on_the_card_matches_float64_cpu(card):
    """StarMap at the shipped weights in float32 on the card (cuDNN, TF32
    off by load_pretrained) against the same network in float64 on the
    CPU, on 8 seeded crops of rendered cars: heat within 1e-4, the same
    found masks, and the peaks within 0.05 heatmap px wherever no tie lies
    within 1e-5."""
    from orcvio_tpu_torch.dataio.render_object import (CAR_KEYPOINTS,
                                                       random_view,
                                                       render_car)
    from orcvio_tpu_torch.models.starmap import (detect_keypoints,
                                                 load_pretrained)

    torch.backends.cudnn.allow_tf32 = True
    net, meta = load_pretrained(device=card)
    assert not torch.backends.cudnn.allow_tf32
    ref, _ = load_pretrained(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(0)
    S = meta["input_size"]
    crops = np.stack([render_car(*random_view(rng, S), S, rng=rng).image
                      for _ in range(8)])
    x = torch.as_tensor(crops)[:, None].expand(8, 3, S, S)
    canon = torch.as_tensor(CAR_KEYPOINTS)
    got = detect_keypoints(net, x.to(card, torch.float32),
                           canon.to(card, torch.float32))
    want = detect_keypoints(ref, x.double(), canon.double())
    with torch.no_grad():
        heat = torch.sigmoid(net(x.to(card, torch.float32))[-1][:, 0])
        heat_ref = torch.sigmoid(ref(x.double())[-1][:, 0])
    assert float((heat.double().cpu() - heat_ref).abs().max()) < 1e-4
    assert torch.equal(got["found"].cpu(), want["found"])
    assert torch.equal(got["peaks_valid"].cpu(), want["peaks_valid"])
    # a slot whose score lies within 1e-5 of another's may change order
    s = want["peaks_score"]
    gap = (s[:, :, None] - s[:, None, :]).abs() + torch.eye(s.shape[1]) * 9
    clear = want["peaks_valid"] & (gap.amin(-1) > 1e-5)
    err = (got["peaks_xy"].double().cpu() - want["peaks_xy"]).norm(dim=-1)
    assert clear.sum() > 8 and float(err[clear].max()) < 0.05


# --- K6: the triangulation's Levenberg-Marquardt loop in one launch ---
# Against the plain version on the card over the same rows (its per-row
# bits, tests/test_torch_triangulate.py), at the fleet cell's shape
# (1024 rows of 32 tracks of 6 observations in a window of 20) and at the
# object path's (12 keypoints over 32 frames, with a prior point partly
# NaN and partly behind the camera, and holes in the masks); each has
# tracks with fewer than 2 observations and a row masked out whole
# (tests/tri_cases.py). Both compute in float64 whatever the tensors'
# type (float32 inputs widened exactly, each output rounded once).
TRI_CASES = {"fleet": dict(B=1024, F=32, T=6, S=20),
             "objects": dict(B=64, F=12, T=32, S=32, prior=True, holes=True)}
TRI_KW = dict(huber=0.01, iters=10, damping=1e-3)


def _tri_both(card, dtype, case, noise, kw=TRI_KW, every=False, **more):
    """K6 under vmap (one launch) against the plain version: each
    feature's gap in p_anchor, p_world and inv_param over its size, and
    the gap between the costs (tri_cost) at the two versions' answers
    over the plain one's, for the valid features (every=False) or for
    every feature of 2 or more observations, whose loop ran on real
    data."""
    from orcvio_tpu_torch.ops import triangulate as k6
    from tri_cases import tri_cost, tri_rows

    rows = tri_rows(**{**TRI_CASES[case], **more}, seed=21, dtype=dtype,
                    device=card, dead_row=True, noise=noise)
    n = k6.triangulate.launches
    got = torch.func.vmap(lambda *a: k6.triangulate(*a, **kw))(
        *(x for x in rows if x is not None))
    torch.cuda.synchronize()
    assert k6.triangulate.launches == n + 1
    want = k6._plain_rows(*rows, **kw)
    assert torch.equal(got[2], want[2])  # anchor_slot
    assert torch.equal(got[3], want[3])  # valid
    assert not bool(got[3][-1].any()) and not bool(got[3][rows[3] < 2].any())
    for i in (0, 1, 4):
        assert torch.equal(torch.isfinite(got[i]), torch.isfinite(want[i]))
    v = want[3]
    if every:
        v = rows[3] >= 2
    else:
        assert int(v.sum()) > v.numel() // 4
    cost = [tri_cost(*rows[:6], x[4])[v] for x in (got, want)]
    return ([((got[i] - want[i]).norm(dim=-1) / want[i].norm(dim=-1))[v]
             for i in (0, 1, 4)],
            (cost[0] - cost[1]).abs() / cost[1].clamp(min=1e-12))


@pytest.mark.parametrize("case", list(TRI_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_triangulate_matches_plain(card, dtype, case):
    """Noise-free tracks, whose minimum has no residual: the valid
    features within 1e-12 (float64) and 1e-5 (float32) of the plain
    version, relative to each feature's size; valid, anchor_slot and which
    outputs are finite identical."""
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for rel in _tri_both(card, dtype, case, noise=0.0)[0]:
        assert float(rel.max()) <= tol


@pytest.mark.parametrize("case", list(TRI_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_triangulate_on_noisy_tracks(card, dtype, case):
    """1e-3 of noise on every observation. The minimum keeps a residual
    r = h/h_z - uv that cancels, so the two versions' costs differ by
    their rounding, and where a step changes the cost by less than that
    one version may accept the step and the other reject it: x then
    differs by that step, at most some sqrt(u) of it (u the float64 unit
    roundoff). Decisions identical as above; the valid features within
    10 sqrt(u) in float64, and within 1e-5 in float32, whose rounding of
    the outputs is larger."""
    tol = 10 * (2.0 ** -53) ** 0.5 if dtype == torch.float64 else 1e-5
    for rel in _tri_both(card, dtype, case, noise=1e-3)[0]:
        assert float(rel.max()) <= tol


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("case", list(TRI_CASES))
def test_triangulate_takes_the_plain_versions_steps(card, case, iters):
    """The loop's path, not its fixed point: 1-3 steps from the initial
    guess, on noisy tracks with outliers well past the Huber threshold
    (their weights 2 huber / e < 1) left in the masks, so each step's
    size, the damping's x10 or /10 and the Huber weights all move x.
    Every feature of 2 or more observations (most of those with an
    outlier fail the cost check), in float64: its cost at K6's answer
    within 1e-9 of the cost at the plain version's, relative; after 1 and
    2 steps x within 1e-10. From the third step on, features that have
    converged reach cost ties (a step that changes the cost by less than
    its rounding, accepted by one version and not the other) or move
    along a direction the cost hardly sees, where x differs by up to 1e-8
    with the cost the same and either version's the lower as often (on an
    H100: 1 of 23,469 fleet features above 1e-12 after 1 and 2 steps, at
    2.8e-12 and 8.1e-12; 4,749 after 3, the largest 1.7e-8, the costs
    within 1.7e-10). A kernel that skipped the Huber weights, swapped the
    damping's x10 and /10 or ran a step fewer moves the cost by far more."""
    kw = {**TRI_KW, "iters": iters}
    rel, cost = _tri_both(card, torch.float64, case, noise=1e-3, kw=kw,
                          every=True, outliers=True)
    assert float(cost.max()) <= 1e-9
    if iters < 3:
        for x in rel:
            assert float(x.max()) <= 1e-10


def test_triangulate_float32_computes_in_float64(card):
    """Cameras within some 3 mm of each other (a static start): float32
    arithmetic leaves the depth to rounding, 1e-4 or more off the float64
    answer (the plain version run in float32 on the same inputs); float32
    K6 lies within 1e-5 of the float64 answer, rounded."""
    from orcvio_tpu_torch.ops import triangulate as k6
    from tri_cases import tri_rows

    rows = tri_rows(32, 32, 6, 20, 22, dtype=torch.float32, device=card,
                    baseline=0.02)
    got = torch.func.vmap(lambda *a: k6.triangulate(*a, **TRI_KW))(
        *(x for x in rows if x is not None))
    want = k6._plain_rows(*rows, **TRI_KW)
    f32 = [torch.stack(x) for x in zip(*(
        k6.triangulate_plain(*(x[b] for x in rows[:6]), None, **TRI_KW)
        for b in range(rows[1].shape[0])))]
    assert torch.equal(got[3], want[3])
    v = want[3] & f32[3]
    assert int(v.sum()) > v.numel() // 4
    for i in (0, 1, 4):
        gap = (got[i] - want[i]).norm(dim=-1) / want[i].norm(dim=-1)
        off = (f32[i] - want[i]).norm(dim=-1) / want[i].norm(dim=-1)
        assert float(gap[v].max()) <= 1e-5
        assert float(off[v].max()) > 1e-4


def test_triangulate_refuses_what_it_cannot_take(card):
    from orcvio_tpu_torch.ops import triangulate as k6
    from tri_cases import tri_rows

    uv, mask, slot, n_obs, R, t, _ = (x[0] if x is not None else None for x
                                      in tri_rows(1, 4, 6, 20, 1,
                                                  device=card))
    with pytest.raises(ValueError, match="slot"):
        k6.triangulate(uv, mask, slot.int(), n_obs, R, t, **TRI_KW)
    with pytest.raises(ValueError, match="R_c2w"):
        k6.triangulate(uv, mask, slot, n_obs, R.float(), t, **TRI_KW)
    with pytest.raises(TypeError):
        k6.triangulate(uv.half(), mask, slot, n_obs, R, t, **TRI_KW)
    n = k6.triangulate.launches
    out = k6.triangulate(uv[:0], mask[:0], slot[:0], n_obs[:0], R, t,
                         **TRI_KW)
    assert [tuple(x.shape) for x in out] == [(0, 3), (0, 3), (0,), (0,),
                                             (0, 3)]
    assert k6.triangulate.launches == n
