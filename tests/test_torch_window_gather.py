"""Kernel K1's plain version and the port's window gather against the JAX
package, on the CPU.

The plain version must be bit-exact against the TPU kernel run in interpret
mode (float32), and the port's gather_windows / gather_level must read the
same pixels as the JAX CPU "slice" path (float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orcvio_tpu.ops.window_gather as jwg
from orcvio_tpu.frontend import klt as jklt
from orcvio_tpu.ops.dma_gather import dma_gather_tiles as jax_dma_gather
from orcvio_tpu_torch.frontend import klt as pklt
from orcvio_tpu_torch.ops import window_gather as pwg
from orcvio_tpu_torch.ops.dma_gather import BL, BR, dma_gather_tiles

torch.set_num_threads(1)


def _case(n, B=1, Hp=560, Wp=896, nr=6, nl=2, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(B, Hp, Wp)).astype(np.float32)
    r0 = rng.integers(0, Hp // BR - nr + 1, n).astype(np.int32)
    c0 = rng.integers(0, Wp // BL - nl + 1, n).astype(np.int32)
    b = rng.integers(0, B, n).astype(np.int32)
    return imgs, r0, c0, b


def _both(imgs, r0, c0, b, nr, nl, bn=8):
    # a small block keeps interpret mode fast; ragged last blocks still occur
    a = dma_gather_tiles(*map(torch.as_tensor, (imgs, r0, c0, b)), nr, nl)
    j = jax_dma_gather(*map(jnp.asarray, (imgs, r0, c0, b)), nr, nl, bn=bn,
                       interpret=True)
    return a.numpy(), np.asarray(j)


@pytest.mark.parametrize("n", [1, 7, 64, 65, 200])
def test_plain_matches_tpu_kernel_ragged(n):
    a, j = _both(*_case(n, seed=n), 6, 2)
    assert a.shape == (n, 48, 256)
    np.testing.assert_array_equal(a, j)


def test_plain_matches_tpu_kernel_multi_image():
    a, j = _both(*_case(90, B=3, seed=1), 4, 1)
    np.testing.assert_array_equal(a, j)


def test_plain_matches_tpu_kernel_orb_extent():
    """ORB's 440 (48, 256) windows a frame: 200 tracks + 240 candidates."""
    a, j = _both(*_case(440, seed=2), 6, 2)
    assert a.shape == (440, 48, 256)
    np.testing.assert_array_equal(a, j)


def test_empty_gather():
    imgs, r0, c0, b = _case(0)
    out = dma_gather_tiles(*map(torch.as_tensor, (imgs, r0, c0, b)), 6, 2)
    assert out.shape == (0, 48, 256) and out.dtype == torch.float32


def _positions(H, W, n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform([3, 3], [W - 3, H - 3], size=(n - 8, 2)),
        [[0.2, 0.3], [W - 1.2, 0.4], [0.5, H - 1.5], [W - 1.5, H - 1.1],
         [1.0, 60.0], [W - 2.0, 60.0], [80.0, 1.0], [80.0, H - 2.0]]])


@pytest.mark.parametrize("t0,wd,rows", [(-18, 36, 48), (-16, 34, 48)])
def test_gather_windows_matches_jax_slice_path(t0, wd, rows):
    rng = np.random.default_rng(3)
    H, W = 120, 160
    img = rng.uniform(0, 255, (1, H, W))
    xy = _positions(H, W, 40, seed=4)
    ai_j = jwg.prepare_image(jnp.asarray(img))
    ai_p = pwg.prepare_image(torch.as_tensor(img))
    np.testing.assert_array_equal(ai_p.padded.numpy(),
                                  np.asarray(ai_j.padded))
    assert (ai_p.hb, ai_p.wb, ai_p.pad, ai_p.shape) == (
        ai_j.hb, ai_j.wb, ai_j.pad, ai_j.shape)
    win_j, org_j = jwg.gather_windows(ai_j, jnp.asarray(xy), t0, wd, rows, 256)
    win_p, org_p = pwg.gather_windows(ai_p, torch.as_tensor(xy), t0, wd, rows,
                                      256)
    np.testing.assert_array_equal(org_p.numpy(), np.asarray(org_j))
    np.testing.assert_array_equal(win_p.numpy(), np.asarray(win_j))


def test_gather_level_logical_windows_match_jax():
    """The JAX CPU path crops windows to 128 lanes and shifts the origin;
    the port keeps the TPU's 256 lanes. Both read the same logical search
    window."""
    rng = np.random.default_rng(5)
    H, W = 120, 160
    img = rng.uniform(0, 255, (H, W))
    xy = _positions(H, W, 40, seed=6)
    lw_j = jklt.gather_level(jwg.prepare_image(jnp.asarray(img)[None]),
                             jnp.asarray(xy))
    lw_p = pklt.gather_level(pwg.prepare_image(torch.as_tensor(img)[None]),
                             torch.as_tensor(xy))
    assert tuple(lw_p.win.shape) == (40, 48, 256)
    np.testing.assert_array_equal(lw_p.start.numpy(), np.asarray(lw_j.start))
    np.testing.assert_array_equal(_logical(lw_p), _logical(lw_j))


def _logical(lw):
    """The logical SEARCH_WD x SEARCH_WD search window of each feature."""
    win, org, st = (np.asarray(lw.win), np.asarray(lw.origin),
                    np.asarray(lw.start))
    wd = pklt.SEARCH_WD
    return np.stack([win[n, dy:dy + wd, dx:dx + wd]
                     for n, (dx, dy) in enumerate((st - org).astype(int))])
