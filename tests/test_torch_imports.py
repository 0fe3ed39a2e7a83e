"""The port's boundaries: no JAX, no reference package, no silent CPU runs.

* No module of orcvio_tpu_torch, nor chip_smoke.py, imports jax, flax or
  orcvio_tpu (by name or as a dotted submodule), nor cv2, yaml, PIL or
  imageio, which the card's machine does not have.
* Importing the whole port leaves jax out of sys.modules.
* Entry points without device= run on CUDA, and raise where there is none.
* Filter flags the port does not run yet raise NotImplementedError.
* Kernel wrappers given CPU tensors take the plain versions: their launch
  counters stay at 0 (K1 to K5).
"""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import orcvio_tpu_torch
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch import run_vio
from orcvio_tpu_torch.dataio.euroc_writer import (make_stream,
                                                  write_euroc_dataset)
from orcvio_tpu_torch.dataio.synthetic import (SimConfig, generate,
                                               smooth_texture)
from orcvio_tpu_torch.eval.staged import (make_e2e_replay, make_tracker_scan,
                                          stage_sequence)
from orcvio_tpu_torch.filter.pipeline import build_chi2_table
from orcvio_tpu_torch.filter.state import FilterState
from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState
from orcvio_tpu_torch.ops.cov_update import cov_update
from orcvio_tpu_torch.ops.dma_gather import dma_gather_tiles
from orcvio_tpu_torch.ops.lk_pallas import (AUX_W, lk_iterate_fused,
                                            lk_iterate_src, lk_level_fused,
                                            lk_level_src)
from orcvio_tpu_torch.scripts.race_extract import extract_pallas
from orcvio_tpu_torch.vio import VioState

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "orcvio_tpu", "cv2", "yaml", "PIL", "imageio")
PORT_FILES = sorted((ROOT / "orcvio_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_import_leaves_jax_unloaded():
    names = [m.name for m in pkgutil.walk_packages(
        orcvio_tpu_torch.__path__, "orcvio_tpu_torch.")]
    assert "orcvio_tpu_torch.frontend.tracker" in names
    assert "orcvio_tpu_torch.scripts.race_extract" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


FILTER_FLAGS = dict(sw_size=4, max_features=8, use_larvio=True,
                    use_left_perturbation=False, use_closed_form_cov_prop=True,
                    if_zupt=True, feature_idp_dim=1, ekf_feature_cap=2)


def test_entry_points_need_a_device(tmp_path):
    tc = TrackerConfig(height=64, width=96, capacity=8, pyramid_levels=2)
    cfg = FilterConfig(**FILTER_FLAGS)
    if torch.cuda.is_available():
        assert callable(make_tracker_scan(tc, np.eye(3)))
        assert callable(make_e2e_replay(cfg, tc, np.eye(3), np.zeros(3)))
        assert TrackerState.create(tc).xy.is_cuda
        assert FilterState.create(cfg).P.is_cuda
        assert VioState.create(cfg, 8).sinit.ref_uv.is_cuda
        assert build_chi2_table(cfg).is_cuda
        assert smooth_texture(16, 16).is_cuda
        assert generate(SimConfig(n_frames=2)).frames.uvs.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make_e2e_replay(cfg, tc, np.eye(3), np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        FilterState.create(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        VioState.create(cfg, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_tracker_scan(tc, np.eye(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        TrackerState.create(tc)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_chi2_table(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        smooth_texture(16, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(SimConfig(n_frames=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_stream(SimConfig(n_frames=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        write_euroc_dataset(str(tmp_path), SimConfig(n_frames=2))
    assert not any(tmp_path.iterdir())  # raised before writing anything
    with pytest.raises(RuntimeError, match="CUDA"):
        run_vio.run_image_sequence(
            cfg, tc, lambda k: np.zeros((64, 96), np.float32), np.zeros(1),
            np.zeros((1, 2)), np.zeros((1, 2, 3)), np.zeros((1, 2, 3)),
            np.ones((1, 2), bool), np.eye(3), np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_vio.main(["--euroc", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        stage_sequence(np.zeros((1, 64, 96), np.uint8), [0.0],
                       np.zeros((1, 2)), np.zeros((1, 2, 3)),
                       np.zeros((1, 2, 3)), np.ones((1, 2), bool))


def test_unported_filter_flags_raise():
    tc = TrackerConfig(height=64, width=96, capacity=8, pyramid_levels=2)
    for flag in ({"use_larvio": False}, {"use_left_perturbation": True},
                 {"joseph_form": True}, {"update_form": "qr"},
                 {"if_fej": True}, {"estimate_td": True}):
        cfg = FilterConfig(**{**FILTER_FLAGS, **flag})
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            make_e2e_replay(cfg, tc, np.eye(3), np.zeros(3), device="cpu")


def test_cpu_tensors_do_not_launch_kernels(monkeypatch):
    monkeypatch.setattr(dma_gather_tiles, "launches", 0)
    monkeypatch.setattr(lk_level_fused, "launches", 0)
    monkeypatch.setattr(cov_update, "launches", 0)
    monkeypatch.setattr(lk_iterate_fused, "launches", 0)
    monkeypatch.setattr(extract_pallas, "launches", 0)
    imgs = torch.rand(1, 64, 256)
    idx = torch.zeros(3, dtype=torch.int32)
    win = dma_gather_tiles(imgs, idx, idx, idx, 6, 2)
    aux = torch.zeros(3, AUX_W)
    aux[:, 0:2] = aux[:, 10:12] = 20.0
    aux[:, 4:6], aux[:, 6:8] = 10.0, 30.0
    out = lk_level_fused(win, win, aux, 3, 15)
    assert win.shape == (3, 48, 256) and out.shape == (3, 8)
    off = torch.zeros(3, dtype=torch.int64)
    assert torch.equal(lk_level_src(imgs[0], off, imgs[0], off, aux, 3, 15),
                       out)
    tmpl = torch.rand(3, 15, 15)
    aux[:, 0] = aux[:, 2] = aux[:, 3] = 1.0
    out = lk_iterate_fused(win, tmpl, tmpl, tmpl, aux, 3, 15)
    assert out.shape == (3, 8)
    assert torch.equal(lk_iterate_src(imgs[0], off, tmpl, tmpl, tmpl, aux, 3,
                                      15), out)
    oy = torch.zeros(2, 3, dtype=torch.int32)
    w, off = extract_pallas(torch.rand(2, 64, 256), oy, oy + 70)
    assert w.shape == (2, 3, 36, 128) and bool((off == 6).all())
    P = torch.eye(4, dtype=torch.float64)
    cov = cov_update(P, torch.ones(4, 2, dtype=torch.float64),
                     torch.ones(2, 4, dtype=torch.float64))
    assert torch.equal(cov, cov.T)
    assert dma_gather_tiles.launches == 0
    assert lk_level_fused.launches == 0
    assert cov_update.launches == 0
    assert lk_iterate_fused.launches == 0
    assert extract_pallas.launches == 0
