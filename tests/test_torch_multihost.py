"""The port's multi-process layer (parallel/multihost.py), its scaling
harness (eval/scaling.py) and the launcher
(orcvio_tpu_torch/scripts/multihost_scaling.py).

* maybe_initialize() is False and does nothing without the ORCVIO_*
  variables; in one process the helpers are the identity;
* the harness in one process on the CPU: finite frames/s, no collective
  in its timed loop;
* the launcher with --procs 2 on gloo CPU processes at the tiny sizes of
  __graft_entry__.py:133-139 (sw 4, 24 features, 12 frames): one JSON
  line, a finite efficiency and hot_loop_collectives == 0. The launcher
  is killed after 120 s, so a hang fails the test.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orcvio_tpu_torch.eval import scaling
from orcvio_tpu_torch.parallel import multihost

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_no_variables_no_group(monkeypatch):
    for var in ("ORCVIO_COORDINATOR", "ORCVIO_NUM_PROCESSES",
                "ORCVIO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.world_size() == 1 and multihost.process_rank() == 0
    mesh = multihost.global_mesh([torch.device("cpu")])
    assert (mesh.rank, mesh.world_size) == (0, 1)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(multihost.all_reduce_sum(x), x)
    assert torch.equal(multihost.all_gather_rows(x), x)
    assert torch.equal(multihost.process_chunk(x), x)
    assert torch.equal(multihost.replicate_to_global({"x": x}, mesh)["x"], x)


def test_harness_in_one_process():
    out = scaling.measure([1, 2], seqs_per_device=1, n_frames=3, reps=1,
                          dtype="float64", device="cpu", size="tiny")
    rows = out["weak_scaling"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["batch"] for r in rows] == [1, 2]
    assert all(r["finite"] and r["fps"] > 0 for r in rows)
    assert all(r["hot_loop_collectives"] == 0 for r in rows)
    assert out["multihost"] is False and rows[0]["efficiency"] == 1.0


def test_collectives_in_the_loop_are_counted():
    with scaling.count_collectives() as calls:
        try:
            torch.distributed.all_reduce(torch.ones(1))
        except (RuntimeError, ValueError):
            pass  # no group: the call was still made
    assert calls["n"] == 1


def test_two_gloo_processes():
    proc = subprocess.run(
        [sys.executable, "orcvio_tpu_torch/scripts/multihost_scaling.py",
         "--procs", "2", "--frames", "12", "--size", "tiny", "--reps", "1",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    res = json.loads(lines[0])
    assert res["hosts"] == 2 and res["multihost"] == "gloo"
    assert math.isfinite(res["scaling_efficiency"])
    assert res["scaling_efficiency"] > 0
    assert res["hot_loop_collectives"] == 0 and res["finite"]
    assert res["shared_card"] is False
