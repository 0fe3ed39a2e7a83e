"""Kernel K5 (64-lane-aligned window extract) and the ported race against
the JAX script ``scripts/race_extract.py``, on the CPU.

The JAX script is loaded as it is, with its module-level ``pl`` swapped for
one whose ``pallas_call`` runs in interpret mode, so its Pallas kernel runs
here. K5's plain version must equal it bit for bit on both outputs (the
windows and the lane offsets), from the race's seeded draws and at the
edges of the image where the TPU kernel's reads are in range; its windows
cut at the offsets must equal the script's ``extract_dynslice``.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from orcvio_tpu_torch.scripts import race_extract as prace

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


class _InterpretPallas:
    """jax.experimental.pallas with pallas_call in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def jrace():
    spec = importlib.util.spec_from_file_location(
        "jax_race_extract", ROOT / "scripts" / "race_extract.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _InterpretPallas()
    return mod


def _ours(img, oy, ox):
    """The port on one frame: prep and extract, batch of one."""
    imgp = prace.prep(torch.as_tensor(img)[None])
    w, off = prace.extract_pallas(imgp, torch.as_tensor(oy)[None],
                                  torch.as_tensor(ox)[None])
    return imgp[0].numpy(), w[0].numpy(), off[0].numpy()


def _cut(w, off, wd=prace.WD):
    return np.stack([w[n, :, o:o + wd] for n, o in enumerate(off)])


def _edges(oy, ox):
    """The draws with their first 8 origins at the image's edges, where the
    TPU kernel's reads are still in range."""
    oy, ox = oy.copy(), ox.copy()
    oy[:8] = [0, 0, prace.HP - prace.WD, prace.HP - prace.WD, 1, 63, 64, 300]
    ox[:8] = [0, prace.WP - 65, 0, prace.WP - 65, 63, 64, 767, 768]
    return oy, ox


@pytest.mark.parametrize("case", ["draws", "edges"])
def test_plain_matches_tpu_kernel(jrace, case):
    imgs, oys, oxs = prace.draws(frames=2)
    for k in range(2):
        oy, ox = (oys[k], oxs[k]) if case == "draws" else _edges(oys[k],
                                                                 oxs[k])
        imgp, w, off = _ours(imgs[k], oy, ox)
        jimgp = jrace.prep(jnp.asarray(imgs[k]))
        np.testing.assert_array_equal(imgp, np.asarray(jimgp))
        jw, joff = jrace.extract_pallas(jimgp, jnp.asarray(oy),
                                        jnp.asarray(ox))
        assert w.shape == (prace.N, prace.WD, 128) and w.dtype == np.float32
        np.testing.assert_array_equal(w, np.asarray(jw))
        np.testing.assert_array_equal(off, np.asarray(joff))
        assert off.min() >= 0 and off.max() <= 63
        np.testing.assert_array_equal(_cut(w, off), np.asarray(
            jrace.extract_dynslice(jimgp, jnp.asarray(oy), jnp.asarray(ox))))


def test_batch_equals_single_calls():
    imgs, oys, oxs = prace.draws(frames=8, seed=3)
    imgp = prace.prep(torch.as_tensor(imgs))
    w, off = prace.extract_pallas(imgp, torch.as_tensor(oys),
                                  torch.as_tensor(oxs))
    assert tuple(w.shape) == (8, prace.N, prace.WD, 128)
    for b in range(8):
        wb, offb = prace.extract_pallas(imgp[b:b + 1],
                                        torch.as_tensor(oys[b:b + 1]),
                                        torch.as_tensor(oxs[b:b + 1]))
        assert torch.equal(wb[0], w[b]) and torch.equal(offb[0], off[b])


def test_any_count_and_none(jrace):
    imgs, oys, oxs = prace.draws(frames=1, seed=4)
    oy, ox = oys[0, :13], oxs[0, :13]
    imgp, w, off = _ours(imgs[0], oy, ox)
    assert w.shape == (13, prace.WD, 128)
    np.testing.assert_array_equal(off, ox - (ox // 64) * 64)
    np.testing.assert_array_equal(_cut(w, off), np.asarray(
        jrace.extract_dynslice(jnp.asarray(imgp), jnp.asarray(oy),
                               jnp.asarray(ox))))
    _, w0, off0 = _ours(imgs[0], oy[:0], ox[:0])
    assert w0.shape == (0, prace.WD, 128) and off0.shape == (0,)


def test_out_of_range_origins_are_clamped():
    """Beyond the TPU kernel's range the origins clamp, so that every read
    lies in the image and the window at the offset is the logical window at
    the clamped origin."""
    rng = np.random.default_rng(5)
    imgp = rng.normal(size=(1, prace.HP, prace.WP)).astype(np.float32)
    oy = np.array([[-5, prace.HP - 10, 0, 100, 200]], np.int32)
    ox = np.array([[-3, 10, prace.WP - 40, prace.WP - 10, 850]], np.int32)
    w, off = prace.extract_pallas(*map(torch.as_tensor, (imgp, oy, ox)))
    y = np.clip(oy[0], 0, prace.HP - prace.WD)
    x = np.clip(ox[0], 0, prace.WP - prace.WD)
    x64 = np.minimum(x // 64 * 64, prace.WP - 128)
    np.testing.assert_array_equal(off[0].numpy(), x - x64)
    for n in range(5):
        np.testing.assert_array_equal(
            w[0, n].numpy(), imgp[0, y[n]:y[n] + prace.WD,
                                  x64[n]:x64[n] + 128])


def test_race_main_on_cpu(capsys):
    res = prace.main(device="cpu", frames=2, reps=1)
    assert set(res) == {"dynslice", "pallas64"}
    for per_b in res.values():
        assert set(per_b) == {1, 8}
        assert all(np.isfinite(v) and v > 0 for v in per_b.values())
    assert "us/extract-equiv  (cpu)" in capsys.readouterr().out
