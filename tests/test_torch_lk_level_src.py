"""K2's level route on the CPU: the windows it reads in place are the
windows K1 cuts.

* The offsets and row stride the level route passes to the kernel
  (``ops/window_gather.py:window_offsets``, stride Wp) address exactly the
  windows ``gather_windows`` cuts: ``torch.as_strided`` on
  ``AlignedImage.padded`` against K1's plain version, bit for bit, at the
  3 levels of a pyramid, centres at and beyond the image edges included;
  with the tracker's 40 px margin, and with a 4 px one, where the tile
  origins themselves are clamped into the padded image.
* ``lk_level_src`` (its plain version here) gives the same bits as
  ``lk_level_fused`` on the cut windows, at eps 0 and 0.01, forward and
  backward.
* On the CPU ``pyr_track`` and ``forward_backward_track`` keep the window
  route: they never call ``lk_level_src``.
* The tracker's search bounds fit the block of the second image the
  kernel stages per feature (``SEARCH_TILE`` pixels square), at every
  level; a NaN row, the kernel's mark of a feature that would not fit, is
  never converged.
"""
import numpy as np
import pytest
import torch

from orcvio_tpu_torch.frontend import klt
from orcvio_tpu_torch.frontend.image import build_pyramid
from orcvio_tpu_torch.ops.dma_gather import dma_gather_tiles_plain
from orcvio_tpu_torch.ops.lk_pallas import (SEARCH_TILE, cut_windows,
                                            lk_level_fused, lk_level_src)
from orcvio_tpu_torch.ops.window_gather import (_window_blocks,
                                                prepare_image, window_offsets,
                                                window_origins)

torch.set_num_threads(1)

H, W, LEVELS, PATCH, ITERS = 240, 320, 3, 15, 10


def _texture(seed):
    rng = np.random.default_rng(seed)
    base = np.kron(rng.normal(size=(H // 8 + 1, W // 8 + 1)), np.ones((8, 8)))
    k = np.ones(7) / 7.0
    for ax in (0, 1):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base)
    return base[:H, :W] * 50.0 + 128.0


def _shifted(img, sx, sy):
    yy, xx = np.mgrid[0:H, 0:W]
    x = np.clip(xx - sx, 0, W - 1.001)
    y = np.clip(yy - sy, 0, H - 1.001)
    ix, iy = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = x - ix, y - iy
    return ((1 - fy) * ((1 - fx) * img[iy, ix] + fx * img[iy, ix + 1])
            + fy * ((1 - fx) * img[iy + 1, ix] + fx * img[iy + 1, ix + 1]))


@pytest.fixture(scope="module")
def pyramids():
    img0 = _texture(3)
    img1 = _shifted(img0, 1.6, -0.8)
    return tuple(klt.prepare_pyramid(build_pyramid(
        torch.as_tensor(im, dtype=torch.float32), LEVELS))
        for im in (img0, img1))


def _centers(n, seed, h=H, w=W):
    """Interior positions, and positions at and beyond every edge of the
    image (clamped into it)."""
    rng = np.random.default_rng(seed)
    edge = [[0.2, 0.3], [w - 1.2, 0.4], [0.5, h - 1.5], [w - 1.5, h - 1.1],
            [-3.0, 40.0], [w + 2.0, 40.0], [60.0, -4.0], [60.0, h + 3.0]]
    return torch.as_tensor(np.concatenate([
        rng.uniform([3, 3], [w - 3, h - 3], size=(n - len(edge), 2)), edge]),
        dtype=torch.float32)


@pytest.mark.parametrize("margin", [klt.MARGIN, 4])
@pytest.mark.parametrize("lv", range(LEVELS))
def test_offsets_address_the_cut_windows(pyramids, lv, margin):
    ai = pyramids[0][lv]
    if margin != klt.MARGIN:
        h, w = ai.shape
        ai = prepare_image(ai.padded[:, ai.pad:ai.pad + h, ai.pad:ai.pad + w],
                           margin=margin)
    h, w = ai.shape
    xy = _centers(40, lv, h, w)
    t0 = -(klt.SEARCH_WD // 2)
    r0, c0, _ = window_origins(ai, xy, t0, klt.ROWS, 2 * klt.LANES)
    if margin != klt.MARGIN:
        oy, ox = _window_blocks(ai, xy, t0)
        assert bool((oy < 0).any() and (ox < 0).any()), "nothing clamped"
        assert int(r0.min()) == 0 and int(c0.min()) == 0
    off = window_offsets(ai, r0, c0)
    assert off.dtype == torch.int64
    Wp = ai.padded.shape[-1]
    shape = (klt.ROWS, 2 * klt.LANES)
    strided = torch.stack([torch.as_strided(ai.padded, shape, (Wp, 1), int(o))
                           for o in off])
    cut = dma_gather_tiles_plain(ai.padded, r0, c0, torch.zeros_like(r0),
                                 klt.ROWS // 8, 2)
    assert torch.equal(strided, cut)
    assert torch.equal(cut_windows(ai.padded[0], off, klt.ROWS,
                                   2 * klt.LANES), cut)
    lw_cut = klt.gather_level(ai, xy)
    lw_src = klt.gather_level(ai, xy, cut=False)
    assert lw_src.win is None and torch.equal(lw_src.offset, off)
    assert lw_src.level.data_ptr() == ai.padded.data_ptr()
    assert torch.equal(lw_cut.origin, lw_src.origin)
    assert torch.equal(lw_cut.start, lw_src.start)
    assert torch.equal(lw_cut.win, cut)


@pytest.mark.parametrize("eps", [0.0, 0.01])
def test_level_route_equals_window_route(pyramids, monkeypatch, eps):
    monkeypatch.setattr(klt, "KLT_EPS", eps)
    xy = _centers(40, 7)
    for lv in range(LEVELS):
        c = xy / 2.0 ** lv
        lws = [[klt.gather_level(pyr[lv], c, cut) for pyr in pyramids]
               for cut in (True, False)]
        fwd = [klt._lk_level(a, b, c, c, PATCH, ITERS) for a, b in lws]
        bwd = [klt._lk_level(b, a, f[0], c, PATCH, ITERS)
               for (a, b), f in zip(lws, fwd)]
        for (pw, rw, cw), (ps, rs, cs) in (fwd, bwd):
            assert torch.equal(pw, ps) and torch.equal(rw, rs)
            assert torch.equal(cw, cs)
        if lv == 0:
            flow = fwd[0][0] - c
            ok = fwd[0][2]
            assert int(ok.sum()) >= 20
            err = torch.linalg.norm(flow[ok] - torch.tensor([1.6, -0.8]),
                                    dim=1)
            assert float(err.median()) < 0.05
    aux, _, _ = klt._level_aux(*lws[0], c, c, PATCH)
    a = lk_level_src(lws[1][0].level, lws[1][0].offset, lws[1][1].level,
                     lws[1][1].offset, aux, ITERS, PATCH, eps)
    b = lk_level_fused(lws[0][0].win, lws[0][1].win, aux, ITERS, PATCH, eps)
    assert torch.equal(a, b)


def test_cpu_tracking_keeps_the_window_route(pyramids, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the level route ran on the CPU")

    monkeypatch.setattr(klt, "lk_level_src", refuse)
    xy = _centers(24, 9)[:16]
    fwd = klt.pyr_track(*pyramids, xy, xy, PATCH, ITERS)
    fb = klt.forward_backward_track(*pyramids, xy, xy, PATCH, ITERS)
    assert tuple(fwd.xy.shape) == (16, 2) and torch.equal(fwd.xy, fb.xy)
    assert bool(fwd.ok.any())


@pytest.mark.parametrize("lv", range(LEVELS))
def test_search_bounds_fit_the_kernels_tile(pyramids, lv):
    """The rows and columns of image 1 every clamped position of a feature
    can reach: from floor(lo - r) to floor(hi - r) + P + 1, as the kernel
    sizes its staged block, within SEARCH_TILE for the tracker's search
    window (at most SEARCH_WD + 1, where lo is not whole)."""
    ai = pyramids[1][lv]
    xy = _centers(40, 11, *ai.shape)
    lw = klt.gather_level(ai, xy)
    lo, hi = klt._search_bounds(lw, PATCH)
    r = (PATCH - 1) // 2
    need = torch.floor(hi - r) - torch.floor(lo - r) + PATCH + 1
    assert int(need.max()) <= klt.SEARCH_WD + 1 <= SEARCH_TILE


def test_nan_rows_are_not_converged():
    lxy = torch.tensor([[10.0, 10.0], [float("nan")] * 2, [10.0, 10.0]])
    step = torch.tensor([0.1, float("nan"), float("nan")])
    det = torch.tensor([5.0, float("nan"), float("nan")])
    lo, hi = torch.full((3, 2), 5.0), torch.full((3, 2), 25.0)
    assert klt._converged(lxy, step, det, lo, hi).tolist() == [True, False,
                                                               False]
