"""The port's boundaries: no JAX, no reference package, no silent CPU runs.

* No module of orcvio_tpu_torch, nor chip_smoke.py, imports jax, flax or
  orcvio_tpu (by name or as a dotted submodule), nor cv2, yaml, PIL or
  imageio, which the card's machine does not have.
* Importing the whole port leaves jax out of sys.modules.
* Entry points without device= run on CUDA, and raise where there is none
  (the batched replay, parallel/'s mesh and the object layer's
  orchestrator, staged replay and config-A run too, and the image path's
  detector, network loader, config-B run and StarMap bench, the scaling
  harness, the batch evaluator and the NEES Monte-Carlo).
* Each object entry point turns cuDNN's TF32 off before its first op, and
  so does each scale-out and tooling entry point (the sequence- and
  feature-parallel updates, the scaling harness, the batch evaluator);
  matplotlib is imported only inside the plotting functions.
* Every filter flag runs: the IMU intrinsics and Schmidt flags build a
  filter state, a frame and a replay on the CPU.
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
from orcvio_tpu_torch.eval.staged import (make_batched_e2e_replay,
                                          make_e2e_replay, make_tracker_scan,
                                          stage_sequence)
from orcvio_tpu_torch.filter.pipeline import build_chi2_table
from orcvio_tpu_torch.filter.state import FilterState
from orcvio_tpu_torch.frontend.tracker import TrackerConfig, TrackerState
from orcvio_tpu_torch.ops.cov_update import cov_update
from orcvio_tpu_torch.ops.dma_gather import dma_gather_tiles
from orcvio_tpu_torch.ops.lk_pallas import (AUX_W, lk_iterate_fused,
                                            lk_iterate_src, lk_level_fused,
                                            lk_level_src)
from orcvio_tpu_torch.parallel.replay import make_mesh
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
    assert "orcvio_tpu_torch.parallel.replay" in names
    for mod in ("residuals", "kf", "sort", "lm", "init", "manager", "update",
                "vio_objects", "staged", "persistence"):
        assert f"orcvio_tpu_torch.objects.{mod}" in names
    for mod in ("eval.objects", "eval.object_map_sim", "config.objects_yaml",
                "dataio.render_object", "models.starmap",
                "models.flax_msgpack", "objects.detector",
                "eval.object_map_cnn", "dataio.kitti", "eval.kitti_objects",
                "scripts.starmap_bench", "parallel.feature_parallel",
                "parallel.temporal", "parallel.multihost", "eval.scaling",
                "eval.batch", "eval.plots", "utils.checkpoint",
                "utils.profiling", "scripts.multihost_scaling",
                "scripts.nees_mc"):
        assert f"orcvio_tpu_torch.{mod}" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_matplotlib_is_imported_on_first_call():
    """The card's machine has no matplotlib: no module of the port imports
    it at module level."""
    for path in PORT_FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                assert not any((m or "").startswith("matplotlib")
                               for m in mods), path.name


def test_port_parses_on_the_oldest_python():
    """pyproject.toml allows Python 3.10: every file of the port parses with
    its grammar (no nested f-string quotes, no type statements)."""
    for path in PORT_FILES:
        ast.parse(path.read_text(), filename=str(path),
                  feature_version=(3, 10))


def test_transition_blocks_are_keyed_by_ints(monkeypatch):
    """Slices hash only from Python 3.12 on, so the blocks that Phi and G
    are assembled from are keyed by (row block, col block) ints."""
    from orcvio_tpu_torch.filter import propagation as prop

    keys = []
    assemble = prop._assemble

    def spy(S, blocks, *a, **kw):
        keys.extend(blocks)
        return assemble(S, blocks, *a, **kw)

    monkeypatch.setattr(prop, "_assemble", spy)
    S, d = 2, torch.float64
    C = torch.eye(3, dtype=d).expand(S, 3, 3)
    v = torch.ones((S, 3), dtype=d)
    dt = torch.full((S,), 0.005, dtype=d)
    prop.phi_closed_form_left(C, dt, v, v, v, v, v, v, v, v[0])
    prop.phi_euler(C, v, v, dt, True)
    prop.phi_euler(C, v, v, dt, False)
    prop.phi_closed_form_right(C, dt, v, v)
    prop.noise_input_matrix(C, True)
    assert len(keys) == 8 + 4 + 5 + 9 + 4
    assert all(type(i) is int and type(j) is int for i, j in keys)


FILTER_FLAGS = dict(sw_size=4, max_features=8, use_larvio=True,
                    use_left_perturbation=False, use_closed_form_cov_prop=True,
                    if_zupt=True, feature_idp_dim=1, ekf_feature_cap=2)


def test_entry_points_need_a_device(tmp_path):
    tc = TrackerConfig(height=64, width=96, capacity=8, pyramid_levels=2)
    cfg = FilterConfig(**FILTER_FLAGS)
    if torch.cuda.is_available():
        assert callable(make_tracker_scan(tc, np.eye(3)))
        assert callable(make_e2e_replay(cfg, tc, np.eye(3), np.zeros(3)))
        assert callable(make_batched_e2e_replay(cfg, tc, np.eye(3),
                                                np.zeros(3)))
        assert all(d.type == "cuda" for d in make_mesh())
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
        make_batched_e2e_replay(cfg, tc, np.eye(3), np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
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
    from orcvio_tpu_torch.eval.object_map_sim import (WorldConfig,
                                                      object_vio_config,
                                                      run_object_mapping)
    from orcvio_tpu_torch.objects.staged import make_objects_replay
    from orcvio_tpu_torch.objects.vio_objects import ObjectVio

    ocfg = object_vio_config(WorldConfig(n_frames=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        ObjectVio(ocfg, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_objects_replay(ocfg, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_object_mapping(WorldConfig(n_frames=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        stage_sequence(np.zeros((1, 64, 96), np.uint8), [0.0],
                       np.zeros((1, 2)), np.zeros((1, 2, 3)),
                       np.zeros((1, 2, 3)), np.ones((1, 2), bool))


def test_scale_out_entry_points_need_a_device(tmp_path):
    from orcvio_tpu_torch.dataio.synthetic import SimConfig, initialized_run
    from orcvio_tpu_torch.eval import batch, scaling
    from orcvio_tpu_torch.scripts import nees_mc

    cfg = FilterConfig(sw_size=4, max_features=8)
    sim = SimConfig(n_frames=2)
    if torch.cuda.is_available():
        assert initialized_run(cfg, sim)[0].P.is_cuda
        return
    calls = [lambda: initialized_run(cfg, sim),
             lambda: scaling.measure([1], n_frames=2, reps=1, size="tiny"),
             lambda: scaling.main(["--frames", "2", "--size", "tiny"]),
             lambda: batch.run_synthetic_case(cfg, sim),
             lambda: batch.run_synthetic_batch_vmap(cfg, [sim]),
             lambda: batch.batch_run_synthetic({"a": {}}, [0]),
             lambda: batch.run_euroc_case(cfg, None, str(tmp_path)),
             lambda: nees_mc.main(["--seeds", "1", "--out",
                                   str(tmp_path / "n.json")])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not any(tmp_path.iterdir())


def test_image_path_entry_points_need_a_device():
    from orcvio_tpu_torch.dataio.render_object import CAR_KEYPOINTS
    from orcvio_tpu_torch.eval.object_map_cnn import run_cnn_object_mapping
    from orcvio_tpu_torch.models.starmap import load_pretrained
    from orcvio_tpu_torch.objects.detector import StarMapKeypointDetector
    from orcvio_tpu_torch.scripts import starmap_bench

    K = (220.0, 220.0, 120.0, 120.0)
    if torch.cuda.is_available():
        assert next(load_pretrained()[0].parameters()).is_cuda
        assert StarMapKeypointDetector(CAR_KEYPOINTS, K).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        StarMapKeypointDetector(CAR_KEYPOINTS, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_pretrained()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_cnn_object_mapping(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        starmap_bench.run(frames=1)


class _Stop(Exception):
    pass


def _stop(*a, **kw):
    raise _Stop


@pytest.mark.parametrize("entry", [
    "ObjectVio", "make_objects_replay", "run_object_mapping",
    "StarMapKeypointDetector", "run_cnn_object_mapping"])
def test_object_entry_points_turn_tf32_off(entry, monkeypatch):
    """cuDNN runs float32 convolutions in TF32 by default (ROADMAP section
    3 item 4): each object entry point turns it off before its first op
    (the config runs are stopped right after their set-up)."""
    from orcvio_tpu_torch.dataio.render_object import CAR_KEYPOINTS
    from orcvio_tpu_torch.eval import object_map_cnn, object_map_sim
    from orcvio_tpu_torch.objects.detector import StarMapKeypointDetector
    from orcvio_tpu_torch.objects.staged import make_objects_replay
    from orcvio_tpu_torch.objects.vio_objects import ObjectVio

    ocfg = object_map_sim.object_vio_config(
        object_map_sim.WorldConfig(n_frames=2))
    monkeypatch.setattr(object_map_sim, "make_world", _stop)
    monkeypatch.setattr(object_map_cnn, "make_world", _stop)
    calls = {
        "ObjectVio": lambda: ObjectVio(ocfg, 8, device="cpu"),
        "make_objects_replay": lambda: make_objects_replay(ocfg, 8,
                                                           device="cpu"),
        "run_object_mapping": lambda: object_map_sim.run_object_mapping(
            object_map_sim.WorldConfig(n_frames=2), device="cpu"),
        "StarMapKeypointDetector": lambda: StarMapKeypointDetector(
            CAR_KEYPOINTS, (220.0, 220.0, 120.0, 120.0), device="cpu",
            geometric_labels=False),
        "run_cnn_object_mapping": lambda: object_map_cnn.
        run_cnn_object_mapping(quick=True, device="cpu")}
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    try:
        calls[entry]()
    except _Stop:
        pass
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("entry", [
    "seq_parallel_replay", "feature_parallel_update", "measure",
    "run_synthetic_case", "run_synthetic_batch_vmap"])
def test_scale_out_entry_points_turn_tf32_off(entry, monkeypatch):
    """Each scale-out and tooling entry point turns TF32 off before its
    first op (each is stopped right after its set-up)."""
    from orcvio_tpu_torch.dataio.synthetic import SimConfig
    from orcvio_tpu_torch.eval import batch, scaling
    from orcvio_tpu_torch.parallel import feature_parallel, multihost, temporal

    monkeypatch.setattr(temporal, "make_block_replay", _stop)
    monkeypatch.setattr(feature_parallel, "pad_feature_axis", _stop)
    monkeypatch.setattr(multihost, "maybe_initialize", _stop)
    monkeypatch.setattr(batch, "_synthetic_start", _stop)
    cfg = FilterConfig(sw_size=4, max_features=8)
    sim = SimConfig(n_frames=2)
    calls = {
        "seq_parallel_replay": lambda: temporal.seq_parallel_replay(
            cfg, None, None, None, n_blocks=2),
        "feature_parallel_update": lambda: feature_parallel.
        feature_parallel_update(cfg, n_shards=2)(
            FilterState.create(cfg, torch.float64, device="cpu"), None, None,
            None),
        "measure": lambda: scaling.measure([1], device="cpu"),
        "run_synthetic_case": lambda: batch.run_synthetic_case(
            cfg, sim, device="cpu"),
        "run_synthetic_batch_vmap": lambda: batch.run_synthetic_batch_vmap(
            cfg, [sim], device="cpu")}
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(_Stop):
        calls[entry]()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("flag", [
    {"calib_imu": True}, {"use_schmidt": True}, {"nuisance_cap": 2},
    {"use_schmidt": True, "nuisance_cap": 2},
    {"calib_imu": True, "use_schmidt": True, "nuisance_cap": 2,
     "schmidt_reference_semantics": True}], ids=str)
def test_unported_filter_flags_raise(flag):
    """The flags the port once refused (ROADMAP item 12 part 2) no longer
    raise: a filter state in their layout, one filter frame from it, and a
    replay on the CPU."""
    from orcvio_tpu_torch.filter.pipeline import FrameInput, filter_step
    from orcvio_tpu_torch.filter.hybrid import nui_base

    cfg = FilterConfig(**{**FILTER_FLAGS, **flag, "sw_size": 4,
                          "max_features": 8, "ekf_feature_cap": 2})
    st = FilterState.create(cfg, torch.float64, device="cpu")
    assert st.P.shape == (cfg.state_dim,) * 2
    assert nui_base(cfg) == cfg.state_dim - 6 * cfg.nuisance_cap
    S, M = 4, 3
    frame = FrameInput(
        t=torch.tensor(0.05, dtype=torch.float64),
        imu_t=torch.linspace(0.0, 0.05, S, dtype=torch.float64),
        imu_gyro=torch.full((S, 3), 0.01, dtype=torch.float64),
        imu_acc=torch.tensor([[0.0, 0.0, 9.81]] * S, dtype=torch.float64),
        imu_mask=torch.ones(S, dtype=torch.bool),
        fids=torch.arange(M, dtype=torch.int32),
        uvs=torch.zeros((M, 2), dtype=torch.float64),
        uv_vels=torch.zeros((M, 2), dtype=torch.float64),
        meas_mask=torch.ones(M, dtype=torch.bool))
    st2, out = filter_step(cfg, st.replace(initialized=torch.tensor(True)),
                           frame, build_chi2_table(cfg, torch.float64, "cpu"))
    assert bool(torch.isfinite(st2.P).all() and torch.isfinite(out.p).all())
    tc = TrackerConfig(height=64, width=96, capacity=8, pyramid_levels=2)
    assert callable(make_e2e_replay(cfg, tc, np.eye(3), np.zeros(3),
                                    device="cpu"))


@pytest.mark.parametrize("flags", [{}, FILTER_FLAGS], ids=["jax_defaults",
                                                            "bench"])
def test_ported_filter_flags_are_supported(flags):
    """FilterConfig() (the JAX package's defaults: OrcVIO propagation, left
    perturbation, Euler Phi, 3-d inverse depth) and the bench flags build a
    replay."""
    cfg = FilterConfig(**flags)
    tc = TrackerConfig(height=64, width=96, capacity=8, pyramid_levels=2)
    assert callable(make_e2e_replay(cfg, tc, np.eye(3), np.zeros(3),
                                    device="cpu"))


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
