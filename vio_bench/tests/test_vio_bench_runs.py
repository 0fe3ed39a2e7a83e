"""Whole runs of the harness at a size the CPU holds (the cell of
tests/data, the look for a card skipped): the result line, the control
that fails, and each fault the cell can have, planted under the timed
path, turning ``correct`` false. One run on the card is marked cuda."""
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import orcvio_tpu_torch.parallel.replay as replay
from vio_bench import harness
from vio_bench.control import readings

DATA = Path(__file__).resolve().parent / "data"
BENCH = DATA / "bench.json"
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(workload, seed=2 ** 31 + 5, trace=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", "1", "--trace", str(trace)],
                          device="cpu", bench_path=BENCH, data=DATA)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["tiny_fleet"])
def test_a_sound_run_is_correct_and_its_line_has_the_keys(cell):
    line = run(cell)
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "compared"
    assert set(line) == set(LINE_KEYS) | {"compared"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) >= {"frames_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]


@pytest.mark.parametrize("cell", ["tiny_fleet"])
def test_the_control_fails_the_limits(cell):
    lims = json.loads((DATA / "limits" / f"{cell}.json").read_text())["limits"]
    (line,) = readings(cell, [11], 1, device="cpu", bench_path=BENCH,
                       data=DATA)
    assert all(line["program"][k] <= lim for k, lim in lims.items())
    assert any(line["control"][k] > lim for k, lim in lims.items())


def _unchanged(step):
    """A step that returns its state unchanged (its outputs as they come)."""
    def broken(cfg, states, frames, chi2):
        _, out = step(cfg, states, frames, chi2)
        return states, out
    return broken


def _half(step):
    """Half of the batch left out: the second half's rows keep their
    state."""
    def broken(cfg, states, frames, chi2):
        new, out = step(cfg, states, frames, chi2)
        keep = torch.arange(states.P.shape[0]) >= states.P.shape[0] // 2
        from orcvio_tpu_torch.tree import tree_map
        return tree_map(lambda a, b: torch.where(
            keep.reshape(-1, *[1] * (a.dim() - 1)), b, a), new, states), out
    return broken


def _altered(step):
    """An answer altered where it is produced: every row's position moved
    by a millimetre."""
    def broken(cfg, states, frames, chi2):
        new, out = step(cfg, states, frames, chi2)
        return new.replace(imu=new.imu.replace(p=new.imu.p + 1e-3)), out
    return broken


def _clone_altered(step):
    """A clone's mean altered where the update produces it: every row's
    clones moved by a millimetre, the IMU's mean and P left as they are."""
    def broken(cfg, states, frames, chi2):
        new, out = step(cfg, states, frames, chi2)
        c = new.clones
        return new.replace(clones=c.replace(p=c.p + 1e-3)), out
    return broken


def _batched_filter(fault):
    """The back end's batched_step with the fault planted around it."""
    orig = replay.batched_step

    def make(cfg):
        step = orig(cfg)
        return lambda s, f, chi2: fault(lambda c, s, f, x: step(s, f, x))(
            cfg, s, f, chi2)
    return make


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered,
                                   _clone_altered],
                         ids=["unchanged", "half_batch", "altered",
                              "clone_altered"])
def test_fleet_faults_make_it_incorrect(monkeypatch, fault):
    monkeypatch.setattr(replay, "batched_step", _batched_filter(fault))
    assert run("tiny_fleet")["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["backend_fleet1024"])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "vio_bench/run.py", "--workload", cell, "--seed",
         "2147483677", "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
