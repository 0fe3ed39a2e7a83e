"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and nvcc, is marked ``cuda`` and skips
where there is none. The file imports neither JAX nor the JAX package, so
it runs on a machine with PyTorch alone (``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K4 (``csrc/cov_update.cu``): float32 within the float32 rounding bound of
two length-q sums, scaled to the inputs (1e-4 at these shapes); float64
to 1e-12. The output is exactly symmetric, whatever the shape.

K3 (``csrc/lk_iterate.cu``): positions within 1e-3 px of the plain
version (both exact float32 taps; the sums differ in order), columns 4-7
exactly 0. K5 (``csrc/extract64.cu``): bit-exact, windows and offsets.
"""
import numpy as np
import pytest
import torch

from orcvio_tpu_torch.frontend import klt
from orcvio_tpu_torch.ops.cov_update import cov_update, cov_update_plain
from orcvio_tpu_torch.ops.lk_pallas import (lk_iterate_fused,
                                            lk_iterate_fused_plain)
from orcvio_tpu_torch.ops.window_gather import prepare_image
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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("D,q", [(172, 444), (172, 384), (172, 9), (50, 20),
                                 (17, 1)])
def test_cov_update_matches_plain(card, dtype, atol, D, q):
    P, K, H = _inputs(D, q, D + q, dtype, card)
    n = cov_update.launches
    out = cov_update(P, K, H)
    torch.cuda.synchronize()
    assert cov_update.launches == n + 1
    assert torch.equal(out, out.T)
    assert float((out - cov_update_plain(P, K, H)).abs().max()) < atol


def test_cov_update_rejects_what_it_cannot_take(card):
    P, K, H = _inputs(20, 8, 0, torch.float32, card)
    with pytest.raises(ValueError):
        cov_update(P, K.double(), H)
    with pytest.raises(TypeError):
        cov_update(P.half(), K.half(), H.half())


def _k3_case(n, device, seed=0):
    """Windows, template and aux of one LK level on a smooth 240x320 frame
    and its shift by (1.7, -0.9) px, as track_level builds them."""
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
    t = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                  device=device)
    xy = t(rng.uniform([20, 20], [300, 220], size=(n, 2)))
    lw0 = klt.gather_level(prepare_image(t(img0)[None], klt.MARGIN), xy)
    lw1 = klt.gather_level(prepare_image(t(img1)[None], klt.MARGIN), xy)
    tmpl = klt._template(lw0, xy, 15)
    aux, _, _ = klt._iterate_aux(lw1, tmpl, xy, 15)
    return lw1.win, tmpl[:3], aux


@pytest.mark.parametrize("lanes", [256, 128])
@pytest.mark.parametrize("n", [200, 13, 0])
def test_lk_iterate_matches_plain(card, n, lanes):
    win, (t, tgx, tgy), aux = _k3_case(n, card)
    win = win[:, :, :lanes].contiguous()
    launches = lk_iterate_fused.launches
    out = lk_iterate_fused(win, t, tgx, tgy, aux, 10, 15)
    torch.cuda.synchronize()
    assert lk_iterate_fused.launches == launches + (n > 0)
    ref = lk_iterate_fused_plain(win, t, tgx, tgy, aux, 10, 15)
    assert tuple(out.shape) == (n, 8)
    if n:
        assert float((out[:, :2] - ref[:, :2]).abs().max()) < 1e-3
        assert float((out[:, 2] - ref[:, 2]).abs().max()) < 1e-3
        assert bool((out[:, 4:] == 0).all())


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
    win, (t, tgx, tgy), aux = _k3_case(4, card)
    with pytest.raises(TypeError):
        lk_iterate_fused(win.double(), t, tgx, tgy, aux, 10, 15)
    with pytest.raises(ValueError):
        lk_iterate_fused(win, t[:, :14, :14].contiguous(), tgx, tgy, aux,
                         10, 15)
    imgp = torch.zeros(2, race.HP, race.WP, device=card)
    oy = torch.zeros(2, 5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        race.extract_pallas(imgp, oy.long(), oy)
    with pytest.raises(TypeError):
        race.extract_pallas(imgp.double(), oy, oy)
