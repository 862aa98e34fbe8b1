"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import re

import pytest
from conftest import BENCH, ROOT

import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert 1 <= len(M["paths"]) <= 16
    for path in M["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch")
    for word in M["command"][1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check with 24 cells must fit its time.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(M["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_names_are_unique_and_plain():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(metrics) == len(set(metrics)) and all(NAME.match(n) for n in metrics)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(NAME.match(w["config"]) and NAME.match(w["traffic"]) for w in M["workloads"])
    assert {w["config"] for w in M["workloads"]} == {c["name"] for c in M["configs"]}


def test_files_are_named_from_names():
    for path in BENCH.rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" in rel or path.is_dir():
            continue
        assert PATH.match(rel), rel


def test_metrics_move_end_to_end_ones():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers == {"plan and table caches", "mesh", "set-up", "assembly and constraints", "linear-solver set-up",
                      "nonlinear loop", "host-device copies", "device", "kernels"}


def test_inverse_roofline_only_where_blocks_are_inverted():
    (gj,) = [m for m in M["per_layer"] if m["name"] == "gj_inverse_roofline_pct"]
    solvers = {w["name"]: json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())[
        "linear_solver"] for w in M["workloads"]}
    assert sorted(gj["workloads"]) == sorted(c for c, s in solvers.items() if s == "schur_direct")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_and_cross_refers(name):
    cell = manifest.load_cell(name)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.chips == 1
    assert cell.traffic["mesh"] == cell.config["mesh"]
    assert cell.traffic["order"] in cell.config["orders"]
    assert callable(manifest.adapter(cell).problem)
    fields = manifest.reference(cell).FIELDS
    assert set(cell.limits) == {"points_gap", *(f"{f}_rms" for f in fields)}
    for metric in cell.per_layer:
        assert callable(manifest.reader(cell, metric["name"]).read)
