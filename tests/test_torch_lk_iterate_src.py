"""K3's level route on the CPU: ``lk_iterate_src`` reads the searched
image's windows in place, as K2's ``lk_level_src`` does.

* ``lk_iterate_src`` (its plain version here, ``cut_windows`` then K3's
  plain version) at the offsets ``window_offsets`` gives the same
  bits as ``lk_iterate_fused`` on the windows K1 cuts, at the 3 levels of a
  pyramid, with the tracker's 40 px margin and with a 4 px one (tile
  origins clamped into the padded image); ``klt._iterate`` likewise on a
  located and on a cut ``LevelWindows``, kernel route and plain.
* On the CPU ``track_level`` keeps the window route (it never calls
  ``lk_iterate_src``) and still matches JAX ``track_level`` within 1e-9 in
  float64.
* ``lk_iterate_src`` on CPU tensors returns the (N, 8) layout with columns
  4-7 zero, launches nothing, and takes N = 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orcvio_tpu.frontend import klt as jklt
from orcvio_tpu_torch.frontend import klt
from orcvio_tpu_torch.frontend.image import build_pyramid
from orcvio_tpu_torch.ops.lk_pallas import (cut_windows, lk_iterate_fused,
                                            lk_iterate_fused_plain,
                                            lk_iterate_src,
                                            lk_iterate_src_plain)
from orcvio_tpu_torch.ops.window_gather import prepare_image
from tests.test_torch_lk_iterate import _frame_pair
from tests.test_torch_lk_level_src import (LEVELS, _centers, _shifted,
                                           _texture)

torch.set_num_threads(1)

PATCH, ITERS = 15, 10


@pytest.fixture(scope="module")
def levels():
    """The raw levels of a texture and of its shift by (1.6, -0.8) px."""
    img0 = _texture(5)
    img1 = _shifted(img0, 1.6, -0.8)
    return tuple(build_pyramid(torch.as_tensor(im, dtype=torch.float32),
                               LEVELS) for im in (img0, img1))


def _k3_inputs(lv0, lv1, xy, margin):
    """The template from lv0's cut window at xy, and lv1 both cut and
    located only, prepared with `margin`."""
    lw0 = klt.gather_level(prepare_image(lv0[None], margin=margin), xy)
    ai1 = prepare_image(lv1[None], margin=margin)
    cut = klt.gather_level(ai1, xy)
    src = klt.gather_level(ai1, xy, cut=False)
    return klt._template(lw0, xy, PATCH), cut, src


@pytest.mark.parametrize("margin", [klt.MARGIN, 4])
@pytest.mark.parametrize("lv", range(LEVELS))
def test_level_route_equals_window_route(levels, lv, margin):
    lv0, lv1 = levels[0][lv], levels[1][lv]
    xy = _centers(40, 20 + lv, *lv0.shape)
    tmpl, cut, src = _k3_inputs(lv0, lv1, xy, margin)
    aux, _, _ = klt._iterate_aux(cut, tmpl, xy, PATCH)
    assert torch.equal(cut_windows(src.level, src.offset, klt.ROWS,
                                   2 * klt.LANES), cut.win)
    a = lk_iterate_src_plain(src.level, src.offset, *tmpl[:3], aux, ITERS,
                             PATCH, klt.ROWS, 2 * klt.LANES)
    b = lk_iterate_fused_plain(cut.win, *tmpl[:3], aux, ITERS, PATCH)
    assert torch.equal(a, b)
    assert torch.equal(lk_iterate_src(src.level, src.offset, *tmpl[:3], aux,
                                      ITERS, PATCH), a)
    for plain in (True, False):
        for x, y in zip(klt._iterate(src, tmpl, xy, PATCH, ITERS, plain),
                        klt._iterate(cut, tmpl, xy, PATCH, ITERS, plain)):
            assert torch.equal(x, y)
    if lv == 0 and margin == klt.MARGIN:
        p, _, conv = klt._iterate(src, tmpl, xy, PATCH, ITERS, False)
        assert int(conv.sum()) >= 20
        err = torch.linalg.norm(p[conv] - xy[conv]
                                - torch.tensor([1.6, -0.8]), dim=1)
        assert float(err.median()) < 0.05


def test_track_level_keeps_the_window_route_on_cpu(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the level route ran on the CPU")

    monkeypatch.setattr(klt, "lk_iterate_src", refuse)
    monkeypatch.setattr(klt, "lk_iterate_src_plain", refuse)
    img0, img1, xy0 = _frame_pair(shift=(1.5, 2.25), seed=4, n=30)
    xy1 = xy0 + 1.0
    p_ref, res_ref, conv_ref = jax.jit(
        jklt.track_level, static_argnums=(4, 5, 6))(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(xy0),
        jnp.asarray(xy1), PATCH, ITERS, 0.01)
    t = torch.as_tensor
    p, res, conv = klt.track_level(t(img0), t(img1), t(xy0), t(xy1), PATCH,
                                   ITERS, 0.01)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_ref), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert conv.numpy().sum() >= 20


@pytest.mark.parametrize("n", [13, 0])
def test_lk_iterate_src_on_cpu_tensors(levels, monkeypatch, n):
    monkeypatch.setattr(lk_iterate_fused, "launches", 0)
    lv0, lv1 = levels[0][0], levels[1][0]
    xy = _centers(16, 3, *lv0.shape)[:n]
    tmpl, cut, src = _k3_inputs(lv0, lv1, xy, klt.MARGIN)
    aux, _, _ = klt._iterate_aux(src, tmpl, xy, PATCH)
    out = lk_iterate_src(src.level, src.offset, *tmpl[:3], aux, ITERS, PATCH)
    assert tuple(out.shape) == (n, 8) and out.dtype == torch.float32
    assert bool((out[:, 4:] == 0).all()) and bool(torch.isfinite(out).all())
    assert lk_iterate_fused.launches == 0
