"""BENCHMARK.json and the files it names: the contract's shapes, names
and the files a cell is found by."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_parses_with_exactly_the_contract_keys():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "vio_bench/run.py"]
    assert SPEC["paths"] == ["vio_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_lines_use_the_allowed_characters():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            lines = {"configs": ("why", "source"), "workloads": ("why",),
                     "per_layer": ("layer",)}.get(group, ())
            for key in lines:
                text = e[key]
                assert 1 <= len(text) <= 200 and "\n" not in text \
                    and "\t" not in text, (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for g in ("configs", "workloads"):
        ns = [n for gg, n in names if gg == g]
        assert len(ns) == len(set(ns))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = _reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in SPEC["per_layer"])


def test_each_layer_metric_moves_what_its_cells_report():
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for cell in m.get("workloads", [w["name"] for w in SPEC["workloads"]]):
            assert m["moves"] in _reports(cell), (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_named_file_exists():
    here = ROOT / "vio_bench"
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("vio_bench/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        mix = json.loads((here / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (here / "drivers" / f"{mix['driver']}.py").exists()
        lims = json.loads((here / "limits" / f"{w['name']}.json").read_text())
        assert lims["limits"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").exists(), m["name"]
        if m["name"].endswith("_roofline"):
            k = m["name"][:-len("_roofline")]
            assert (here / "rooflines" / f"{k}.py").exists()


@pytest.mark.parametrize("path", sorted(
    p for p in (ROOT / "vio_bench").rglob("*")
    if p.is_file() and "__pycache__" not in p.parts
    and "_cache" not in p.parts))
def test_file_names_use_name_characters(path):
    rel = path.relative_to(ROOT).as_posix()
    assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
