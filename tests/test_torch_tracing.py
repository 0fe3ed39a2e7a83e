"""The port's stage spans (utils/profiling.py:span), on the port alone.

* under torch.profiler (CPU activity), one filter_step records each of
  its stages once, in order, the MSCKF and the hybrid configuration
  alike, and the batched step (B = 2) records each once per call, not
  per row; every aten op lies in exactly one top-level stage, and the
  ZUPT and classification stages hold work exactly where the flags ask
  for it; sharded_replay_fn records replay.call with shard, step and
  gather under it, and the filter's stages under each step;
* with no profiler running a span records nothing (its range op patched
  to raise, the step still runs), and a step's outputs are the same bits
  with and without a profiler;
* chip_smoke.py's device rows leave out the device-side images of the
  spans, which the profiler adds while it traces the host too.

The fixture is a tiny synthetic run (dataio/synthetic.py:initialized_run)
advanced past its clone window's filling, so that triangulations and
updates are under way.
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import orcvio_tpu_torch.utils.profiling as profiling
from orcvio_tpu_torch.config.core import FilterConfig
from orcvio_tpu_torch.dataio.synthetic import SimConfig, initialized_run
from orcvio_tpu_torch.filter.pipeline import (FrameInput, filter_step,
                                              run_sequence)
from orcvio_tpu_torch.parallel.replay import batched_step, sharded_replay_fn
from orcvio_tpu_torch.tree import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

MSCKF = dict(sw_size=6, max_features=40, max_track_len=4, imu_slab=12,
             max_update_features=8, observation_noise=0.004,
             tri_translation_threshold=-1.0)
HYBRID = dict(MSCKF, if_zupt=True, ekf_feature_cap=6, feature_idp_dim=1,
              zupt_max_feature_dis=0.012)
SIM = SimConfig(n_frames=10, n_landmarks=120, max_obs=30, imu_slab=12,
                uv_noise=0.002, seed=3)
WARM = 8  # frames run before the traced one

STAGES = ["filter.propagate", "filter.augment", "filter.ingest",
          "filter.zupt", "filter.classify", "filter.triangulate",
          "filter.jacobians", "filter.update", "filter.select",
          "filter.last_chance", "filter.prune"]
LAST_CHANCE = ["filter.triangulate", "filter.jacobians", "filter.update"]


class Run:
    """A configuration's state after WARM frames, its next frames and its
    chi-square table."""

    def __init__(self, flags):
        self.cfg = FilterConfig(**flags)
        st, frames, self.chi2 = initialized_run(self.cfg, SIM,
                                                torch.float64, "cpu")
        warm = FrameInput(*(x[:WARM] for x in frames))
        self.state, _ = run_sequence(self.cfg, st, warm, self.chi2)
        self.frames = frames  # (T, ...)

    def frame(self, k=WARM):
        return FrameInput(*(x[k] for x in self.frames))

    def rows(self, x, n=2):
        """x repeated as n rows."""
        return tree_map(lambda a: torch.stack([a] * n), x)


@pytest.fixture(scope="module")
def runs():
    return {"msckf": Run(MSCKF), "hybrid": Run(HYBRID)}


def recorded(fn):
    """fn()'s result and the [(name, start_ns, end_ns)] of every CPU event
    recorded while it ran, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return out, sorted(evs, key=lambda e: (e[1], -e[2]))


def inside(e, outer):
    return outer[1] <= e[1] and e[2] <= outer[2] and e is not outer


def children(evs, parent=None):
    """The spans directly under parent (under no span where None), in
    order."""
    sp = [e for e in evs if e[0].startswith(profiling.SPAN_PREFIX)]
    within = [e for e in sp if parent is None or inside(e, parent)]
    return [e for e in within
            if not any(inside(e, o) for o in within)]


def names(evs):
    return [e[0][len(profiling.SPAN_PREFIX):] for e in evs]


def one_step(r):
    frame = r.frame()
    return lambda: filter_step(r.cfg, r.state, frame, r.chi2)


def two_rows(r):
    st, fr = r.rows(r.state), r.rows(r.frame())
    step = batched_step(r.cfg)
    return lambda: step(st, fr, r.chi2)


@pytest.mark.parametrize("flags, call", [
    ("msckf", one_step), ("msckf", two_rows), ("hybrid", one_step)],
    ids=["filter_step", "batched_step_B2", "hybrid_filter_step"])
def test_a_step_records_each_stage_once_in_order(runs, flags, call):
    _, evs = recorded(call(runs[flags]))
    top = children(evs)
    assert names(top) == STAGES
    (lc,) = [e for e in top if e[0].endswith("filter.last_chance")]
    assert names(children(evs, lc)) == LAST_CHANCE
    assert sum(e[0].startswith(profiling.SPAN_PREFIX) for e in evs) == \
        len(STAGES) + len(LAST_CHANCE)


def ops_by_stage(evs):
    """{stage: the names of the aten ops inside it}, after checking that
    each aten op lies in exactly one top-level stage."""
    top = children(evs)
    ops = [e for e in evs if e[0].startswith("aten::")]
    assert len(ops) > 100
    out = {n: set() for n in names(top)}
    for op in ops:
        holders = [s for s in top if s[1] <= op[1] and op[2] <= s[2]]
        assert len(holders) == 1, op
        out[names(holders)[0]].add(op[0])
    return out


@pytest.mark.parametrize("flags", ["msckf", "hybrid"])
def test_each_aten_op_lies_in_one_top_level_stage(runs, flags):
    _, evs = recorded(one_step(runs[flags]))
    assert all(ops for s, ops in ops_by_stage(evs).items()
               if s not in ("filter.zupt", "filter.classify"))


@pytest.mark.parametrize("flags", ["msckf", "hybrid"])
def test_zupt_and_classify_hold_work_where_the_flags_ask(runs, flags):
    _, evs = recorded(one_step(runs[flags]))
    ops = ops_by_stage(evs)
    hybrid = flags == "hybrid"
    # without ZUPT the stage makes its "no ZUPT" flag alone
    flag = {"aten::zeros", "aten::empty", "aten::zero_", "aten::fill_"}
    assert (not ops["filter.zupt"] <= flag) == hybrid
    assert bool(ops["filter.classify"]) == hybrid


def test_replay_call_holds_shard_steps_and_gather(runs):
    r = runs["msckf"]
    fn = sharded_replay_fn(r.cfg, [torch.device("cpu")])
    frames = tree_map(lambda x: x[WARM:WARM + 2], r.frames)  # (T = 2, ...)
    _, evs = recorded(lambda: fn(r.rows(r.state), r.rows(frames), r.chi2))
    (call,) = children(evs)
    assert names([call]) == ["replay.call"]
    parts = children(evs, call)
    assert names(parts) == ["replay.shard", "replay.step", "replay.step",
                            "replay.gather"]
    for step in parts[1:3]:
        assert names(children(evs, step)) == STAGES


def test_a_span_is_off_without_a_profiler(runs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range was made for {name}")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span("a") is profiling.span("b")
    _, out = two_rows(runs["msckf"])()
    assert torch.isfinite(out.p).all()
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.span("a")


def test_outputs_are_the_same_bits_under_a_profiler(runs):
    call = two_rows(runs["msckf"])
    plain = call()
    traced, _ = recorded(call)
    for a, b in zip(torch.utils._pytree.tree_leaves(plain),
                    torch.utils._pytree.tree_leaves(traced)):
        assert torch.equal(a, b)


def test_chip_smoke_counts_no_span_as_a_kernel():
    def event(name, ms, on_device=True):
        kind = torch.autograd.DeviceType.CUDA if on_device else \
            torch.autograd.DeviceType.CPU
        return SimpleNamespace(
            name=lambda: name, device_type=lambda: kind,
            duration_ns=lambda: int(ms * 1e6), is_async=lambda: False,
            start_thread_id=lambda: 0, end_thread_id=lambda: 0)

    events = [event("gemm", 2.0), event("gemm", 1.0),
              event(profiling.SPAN_PREFIX + "filter.update", 5.0),
              event(profiling.SPAN_PREFIX + "filter.update", 4.0, False),
              event("Optimizer.step#Adam.step", 3.0)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert chip_smoke.device_rows(prof) == {"gemm": [3.0, 2]}
