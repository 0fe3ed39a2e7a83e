"""The end-to-end cell (vio_bench: config euroc_larvio, mix mc256_plane600,
driver e2e_replay) at a size the CPU holds, and the tracker's and the
replay's spans and counters.

The cell runs through ``vio_bench/harness.py:main`` on the CPU with the
shipped configuration cut to a 188x120 camera (a quarter of the
intrinsics), 40 tracks, 2 levels, a 6-clone window and 6 in-state
features, 4 rows over a 40-frame stream whose still start is 1 s (static
init after 5 still frames), and 4 checked frames in every row. On the CPU the
port's tracker runs in the filter's float64, so the plain reference
(``vio_bench/reference/frontend.py``, ``larvio.py``) meets the program to
rounding there; the planted faults must turn the cell's own limits
(``vio_bench/limits/vio_mc256.json``) false, as the float16 and float32
controls do.
"""
import ast
import contextlib
import copy
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import orcvio_tpu_torch.filter.pipeline as pipeline
import orcvio_tpu_torch.frontend.tracker as tracker
import orcvio_tpu_torch.utils.profiling as profiling
from orcvio_tpu_torch.eval import staged
from orcvio_tpu_torch.filter.pipeline import FrameInput, build_chi2_table
from orcvio_tpu_torch.tree import tree_index, tree_map
from orcvio_tpu_torch.vio import batched_vio_step

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench import check, check_e2e, harness  # noqa: E402
from vio_bench.drivers import e2e_replay  # noqa: E402
from vio_bench.reference import frontend as ref_fe  # noqa: E402
from vio_bench.reference import larvio as ref_be  # noqa: E402

torch.set_num_threads(2)
SEED = 2 ** 31 + 12345
LIMITS = json.loads((ROOT / "vio_bench/limits/vio_mc256.json").read_text())[
    "limits"]
FRONTEND = ["frontend.equalize", "frontend.pyramid", "frontend.klt",
            "frontend.detect", "frontend.orb", "frontend.undistort",
            "frontend.ransac", "frontend.place"]


def tiny_cell(tmp: Path):
    """(bench path, data dir) of the cut cell, written under tmp."""
    cfg = json.loads((ROOT / "vio_bench/configs/euroc_larvio.json")
                     .read_text())
    cfg.update(name="tiny_larvio", n_frames=40)
    cfg["camera"].update(width=188, height=120, fx=114.5, fy=114.5, cx=94.0,
                         cy=60.0)
    cfg["writer"].update(tex_size=1024, tex_scale=0.036)
    cfg["tracker"].update(height=120, width=188, pyramid_levels=2,
                          capacity=40, grid_rows=4, grid_cols=4,
                          min_distance=8.0, K=[114.5, 114.5, 94.0, 60.0])
    cfg["filter"].update(sw_size=6, max_features=40, max_update_features=8,
                         max_track_len=4, ekf_feature_cap=6,
                         static_image_num=5, static_min_matches=10)
    mix = json.loads((ROOT / "vio_bench/traffic/mc256_plane600.json")
                     .read_text())
    mix.update(rows=4, setup_frames=20)
    mix["trajectory"].update(static_time=1.0, ramp_time=0.5)
    mix["check"] = {"ticks": 4, "rows": 4, "within_ticks": 16}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny_larvio", "source": "test",
                        "file": str(tmp / "tiny_larvio.json"),
                        "reduced": cfg["reduced"], "why": "test"}]
    spec["workloads"] = [{"name": "tiny_mc", "config": "tiny_larvio",
                          "traffic": "tiny_mc", "chips": 1, "why": "test"}]
    spec["per_layer"] = [dict(m, workloads=["tiny_mc"])
                         for m in spec["per_layer"]
                         if "vio_mc256" in m.get("workloads", [])]
    for sub in ("traffic", "limits"):
        (tmp / sub).mkdir()
    (tmp / "tiny_larvio.json").write_text(json.dumps(cfg))
    (tmp / "traffic/tiny_mc.json").write_text(json.dumps(mix))
    (tmp / "limits/tiny_mc.json").write_text(json.dumps({"limits": LIMITS}))
    (tmp / "bench.json").write_text(json.dumps(spec))
    return tmp / "bench.json", tmp


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cut cell's run: its result line, and the driver as it stood
    before release (its kept states and the checked frames)."""
    bench, data = tiny_cell(tmp_path_factory.mktemp("cell"))
    stash = {}
    release = e2e_replay.Driver.release

    def keep(self):
        stash["driver"] = copy.copy(self)
        release(self)
        stash["checked"] = self.checked

    e2e_replay.Driver.release = keep
    # this test session loads JAX (tests/conftest.py), which the harness
    # refuses; the imports of the cell's own modules are held apart below
    found = harness.forbidden_modules
    harness.forbidden_modules = list
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = harness.main(["--workload", "tiny_mc", "--seed", str(SEED),
                               "--seconds", "1", "--trace", "1"],
                              device="cpu", bench_path=bench, data=data)
    finally:
        e2e_replay.Driver.release = release
        harness.forbidden_modules = found
    assert rc == 0
    stash["line"] = json.loads(out.getvalue().splitlines()[-1])
    stash["cfg"] = json.loads((data / "tiny_larvio.json").read_text())
    stash["seen"], counted = paths_counted()
    with counted:
        stash["program"] = numbers(stash)
    stash["control"] = numbers(stash, control=True)
    return stash


PATHS = ("zupt_update", "join", "feature_row", "last_chance", "reanchor")


def paths_counted():
    """({path: calls}, a context in which the reference counts its calls
    of each of PATHS; reanchor only where a feature's anchor is pruned)."""
    seen = dict.fromkeys(PATHS, 0)

    def counted(name, inner):
        def wrapped(*a, **k):
            if name != "reanchor" or any(
                    a[2][a[1]["anchor_slot"][i]] and a[1]["anchor_slot"][i]
                    != a[3] for i in np.nonzero(a[1]["in_state"])[0]):
                seen[name] += 1
            return inner(*a, **k)
        return wrapped

    stack = contextlib.ExitStack()
    for name in PATHS:
        inner = getattr(ref_be, name)
        setattr(ref_be, name, counted(name, inner))
        stack.callback(setattr, ref_be, name, inner)
    return seen, stack


def numbers(cell, checked=None, control=False, samples=None, zupt=None):
    """check_e2e.numbers of the run's checked frames (of those named:
    samples and zupt lists of indices)."""
    checked = dict(checked or cell["checked"])
    for key, keep in (("samples", samples), ("zupt", zupt)):
        if keep is not None:
            checked[key] = [checked[key][i] for i in keep]
    return check_e2e.numbers(cell["cfg"], checked, control)


def test_the_cell_runs_correct_with_its_counters(cell):
    line = cell["line"]
    assert line["correct"] and line["failed"] == 0
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 20 <= m["tracks_per_row"] <= 40  # of 40 rows, mostly kept
    assert 50 <= m["lk_ok_pct"] <= 100 and 50 <= m["ransac_inlier_pct"] <= 100
    assert 0 < m["ekf_features_per_row"] <= 6  # the in-state cap
    assert set(line["compared"]) == set(LIMITS)


# On the CPU the program's tracker and filter are float64 like the
# reference: the tracker's discrete choices agree exactly and its
# positions to float64 rounding of the same sums (1e-9 px); the filter
# agrees to the rounding of two orders of the same algebra (1e-9 of each
# block's scale, some 1e-13 seen); static init is one formula (1e-12).
TOL = {"track_ids": 0.0, "track_px": 1e-9, "filter_rel": 1e-9,
       "zupt_rel": 1e-9, "init_rel": 1e-12}


@pytest.mark.parametrize("name", sorted(TOL))
def test_the_reference_meets_the_program(cell, name):
    assert cell["program"][name] <= TOL[name]


def test_the_checked_frames_exercise_the_hybrid_filter(cell):
    """The checked frames lie on the moving part and take the reference
    through ZUPT, the joins, the in-state rows, the last-chance update and
    an anchor change."""
    assert all(s["frame"] >= 20 for s in cell["checked"]["samples"])
    assert all(cell["seen"].values()), cell["seen"]


def _judged(numbers_):
    return check.judge(numbers_, {k: LIMITS[k] for k in numbers_})[0]


def test_a_tracker_that_returns_its_state_is_caught(cell):
    checked = copy.deepcopy(cell["checked"])
    for s in checked["samples"]:
        s["tracker_out"] = s["tracker_in"]
    assert not _judged(numbers(cell, checked, samples=[0], zupt=[]))


def test_an_altered_inverse_depth_is_caught(cell):
    checked = copy.deepcopy(cell["checked"])
    n = next(n for n, s in enumerate(checked["samples"])
             if s["filter_out"]["in_state"].any())
    s = checked["samples"][n]
    i = int(np.nonzero(s["filter_out"]["in_state"])[0][0])
    s["filter_out"]["idp"][i, 2] *= 1 + 1e-5
    assert not _judged(numbers(cell, checked, samples=[n], zupt=[]))


@pytest.mark.parametrize("name", ["track_ids", "filter_rel", "zupt_rel"])
def test_the_controls_fail(cell, name):
    """The reference one step down (float16 tracker, float32 filter) in
    the program's place fails the limits."""
    assert cell["control"][name] > LIMITS[name]


def _row_frame(cell):
    """(driver, frame k, row r, the row's tracker state before k, its
    RANSAC draw) of the first checked tick."""
    d = cell["driver"]
    k, (ts, _, rng), _ = d.sampler.kept[0]
    r = d.sampler.rows[0]
    g = torch.Generator().manual_seed(0)
    g.set_state(rng[r])
    ts_r = tree_index(ts.replace(rng=None), r).replace(rng=g)
    gumbel = torch.as_tensor(cell["checked"]["samples"][0]["gumbel"])
    return d, k, r, ts_r, gumbel


def _track(d, k, ts, gumbel):
    R = torch.as_tensor(d.cfg["extrinsics"]["R_b2c"], dtype=d.tdt)
    return staged._track(d.tc, ts, d.staged, k, R, d.dtype, gumbel)


def _ref(cell, k, before, gumbel):
    d, tc = cell["driver"], cell["cfg"]["tracker"]
    prep = [ref_fe.prepare(tc, d.staged.images[j].numpy()) for j in (k - 1, k)]
    imu = e2e_replay.imu_dict(d.staged, k)
    return ref_fe.frame(tc, *prep, before, float(d.staged.frame_ts[k]), imu,
                        d.cfg["extrinsics"]["R_b2c"], gumbel.numpy(), k)


def _state(ts):
    return {"xy": ts.xy.numpy(), "uvn": ts.uvn.numpy(),
            "desc": ts.desc.numpy(), "fid": ts.fid.numpy().astype(np.int64),
            "t": ts.t.numpy(), "next_id": int(ts.next_id)}


def test_ransac_forced_to_keep_every_track_is_caught(cell, monkeypatch):
    """Twelve tracks' last bearings moved 3 px, each another way, off their
    epipolar lines (the scene is a plane, so one shared shift would fit an
    F of its family): RANSAC drops them in the program and in the
    reference; with its inliers forced all true the program keeps them."""
    d, k, r, ts, gumbel = _row_frame(cell)
    rows = torch.nonzero(ts.fid >= 0)[:12, 0]
    a = 2 * np.pi * np.arange(len(rows)) / len(rows)
    shift = 0.025 * np.stack([np.cos(a), np.sin(a)], 1)
    ts = ts.replace(uvn=ts.uvn.index_add(
        0, rows, torch.as_tensor(shift, dtype=ts.uvn.dtype)))
    before = _state(ts)
    want = _ref(cell, k, before, gumbel)
    good = _state(_track(d, k, ts, gumbel)[0])
    monkeypatch.setattr(tracker, "ransac_fundamental",
                        lambda p1, p2, valid, **kw: (valid, None))
    bad = _state(_track(d, k, ts, gumbel)[0])
    share = [check_e2e.track_numbers(x, want, before)[0] / len(want["fid"])
             for x in (good, bad)]
    assert share[0] <= LIMITS["track_ids"] < share[1]


def test_zupt_skipped_is_caught(cell, monkeypatch):
    """The kept ZUPT frame run again with the ZUPT update skipped."""
    d = cell["driver"]
    zb, za, zts = d.zupt_kept
    kz = d.zupt_frame
    st = d.staged
    B = zts.fid.shape[0]
    frame = FrameInput(
        t=st.frame_ts[kz].expand(B), imu_t=st.imu_t[kz].expand(B, -1),
        imu_gyro=st.imu_gyro[kz].expand(B, -1, -1),
        imu_acc=st.imu_acc[kz].expand(B, -1, -1),
        imu_mask=st.imu_mask[kz].expand(B, -1), fids=zts.fid,
        uvs=zts.uvn.to(d.dtype), uv_vels=torch.zeros_like(zts.uvn),
        meas_mask=zts.fid >= 0)
    chi2 = build_chi2_table(d.fc, d.dtype, "cpu")
    again, _ = batched_vio_step(d.fc, zb, frame, chi2)
    assert torch.equal(again.filter.P, za.filter.P)
    monkeypatch.setattr(pipeline, "zupt_update", lambda cfg, s: s)
    skipped, _ = batched_vio_step(d.fc, zb, frame, chi2)
    checked = copy.deepcopy(cell["checked"])
    for z in checked["zupt"]:
        z["filter_out"] = e2e_replay.filter_dict(skipped, z["row"])
    assert not _judged(numbers(cell, checked, samples=[]))


@pytest.fixture(scope="module")
def moved(cell):
    """The first checked tick on rows made to differ, since the cell's
    rows see one plane and keep every track whatever their RANSAC draws:
    row r's tracks moved r/3 px (positions and bearings alike), its
    position r cm, then the frame through the program's batched replay.
    (frame, states before, states after)."""
    d = cell["driver"]
    k, (ts, vs, rng), _ = d.sampler.kept[0]
    r = torch.arange(ts.fid.shape[0], dtype=ts.xy.dtype)[:, None, None]
    px = r / 3 * torch.tensor([1.0, -0.5], dtype=ts.xy.dtype) \
        * (ts.fid >= 0)[..., None]
    gens = []
    for state in rng:
        gens.append(torch.Generator().manual_seed(0))
        gens[-1].set_state(state)
    ts = ts.replace(xy=ts.xy + px, uvn=ts.uvn + px / d.tc.K[0],
                    rng=tuple(gens))
    imu = vs.filter.imu
    vs = vs.replace(filter=vs.filter.replace(imu=imu.replace(
        p=imu.p + 0.01 * r[:, 0])))
    after, _ = d.replay(ts, vs, d.staged, frames=[k])
    return k, (ts, vs, rng), after


ROW_FAULTS = {
    "none": lambda ts, vs: (ts, vs),
    # every row given row 0's tracker state
    "tracker_row0": lambda ts, vs: (
        tree_map(lambda x: x[:1].expand_as(x).clone(), ts), vs),
    # the filter's rows one place off, as a wrong batch stride would leave
    # them
    "filter_rolled": lambda ts, vs: (
        ts, tree_map(lambda x: x.roll(1, 0), vs)),
}


@pytest.mark.parametrize("fault", sorted(ROW_FAULTS))
def test_a_row_given_another_rows_frame_is_caught(cell, moved, fault):
    """On rows that differ, the check passes the program as it is and
    catches a fault that mixes rows."""
    d, tracker_dict = cell["driver"], e2e_replay.tracker_dict
    k, before, after = moved
    rows = (1, d.rows - 1)
    a, b = (tracker_dict(after[0], r) for r in rows)
    both = (a["fid"] >= 0) & (a["fid"] == b["fid"])
    # the rows' tracks lie apart, their filters too
    gap = np.linalg.norm(a["xy"] - b["xy"], axis=1)[both]
    assert both.any() and gap.min() > 0.5
    p = after[1].filter.imu.p
    assert float((p[rows[0]] - p[rows[1]]).abs().max()) > 0.01
    samples = [d.sample(k, before, ROW_FAULTS[fault](*after), r)
               for r in rows]
    checked = dict(cell["checked"], samples=samples)
    assert _judged(numbers(cell, checked, zupt=[])) == (fault == "none")


def test_the_tracker_counts_match_the_reference(cell):
    """TrackerOutput's gate counts against the reference's count of the
    same frame (float64 on both sides, so every choice agrees)."""
    d, k, r, ts, gumbel = _row_frame(cell)
    before = _state(ts)
    _, _, counts = _track(d, k, ts, gumbel)
    want = _ref(cell, k, before, gumbel)["counts"]
    assert {n: int(c) for n, c in counts.items()} == want
    assert want["n_lk_in"] == int((ts.fid >= 0).sum())
    assert want["n_lk_in"] >= want["n_lk_ok"] >= want["n_orb_ok"] \
        >= want["n_inliers"]


def _spans(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(profiling.SPAN_PREFIX)),
                 key=lambda e: (e[1], -e[2]))
    return [(n[len(profiling.SPAN_PREFIX):], a, b) for n, a, b in evs]


def test_the_tracker_records_each_stage_once_in_order(cell):
    d, k, r, ts, gumbel = _row_frame(cell)
    spans = _spans(lambda: _track(d, k, ts, gumbel))
    assert [n for n, *_ in spans] == FRONTEND


def test_the_replay_records_track_then_vio_each_once(cell):
    d = cell["driver"]
    k, (ts, vs, _), _ = d.sampler.kept[0]
    spans = _spans(lambda: d.replay(ts, vs, d.staged, frames=[k]))
    top = [s for s in spans if not any(o[1] <= s[1] and s[2] <= o[2]
                                       and o is not s for o in spans)]
    assert [n for n, *_ in top] == ["replay.track", "replay.vio"]
    inner = [n for n, a, b in spans if top[0][1] <= a and b <= top[0][2]]
    assert inner[1:] == FRONTEND  # once a batched call, not once a row
    assert "filter.update" in [n for n, a, b in spans
                               if top[1][1] <= a and b <= top[1][2]]


def test_the_spans_are_off_without_a_profiler(cell, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range was made for {name}")

    monkeypatch.setattr(profiling, "record_function", refuse)
    d = cell["driver"]
    k, (ts, vs, _), _ = d.sampler.kept[0]
    (_, vs1), outs = d.replay(ts, vs, d.staged, frames=[k])
    assert torch.isfinite(outs["p"]).all()


def _imports(path: Path) -> set:
    """The modules a file imports, relative ones resolved within
    vio_bench."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = path.parent
                for _ in range(node.level - 1):
                    base = base.parent
                mod = base.relative_to(ROOT).as_posix().replace("/", ".")
                out.add(f"{mod}.{node.module}" if node.module else mod)
                out |= {f"{mod}.{a.name}" for a in node.names}
            else:
                out.add(node.module)
    return out


@pytest.mark.parametrize("name", ["reference/frontend.py",
                                  "reference/larvio.py", "check_e2e.py",
                                  "stream.py"])
def test_the_references_import_nothing_of_either_package(name):
    seen, todo = set(), [ROOT / "vio_bench" / name]
    while todo:
        path = todo.pop()
        for mod in _imports(path):
            assert not mod.split(".")[0].startswith("orcvio_tpu"), (path, mod)
            f = ROOT / (mod.replace(".", "/") + ".py")
            if mod.startswith("vio_bench") and f.exists() and f not in seen:
                seen.add(f)
                todo.append(f)
