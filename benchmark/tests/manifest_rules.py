"""BENCHMARK.json against the benchmark's contract, and every file it names:
each rule a function of a manifest and the root of the checkout that holds
it.  ``check`` runs them all.  ``test_bench_manifest`` runs each on the
repo; the files-alone test runs ``check`` on a checkout it extended, so a
rule that an added cell, metric or layer would break shows there."""

import json
import re
from pathlib import Path

import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# The layers of PERF.md's list that the benchmark measures: each stays in
# use, and a later cell may add others.
LAYERS = {"plan and table caches", "mesh", "set-up", "assembly and constraints",
          "linear-solver set-up", "nonlinear loop", "time march", "host-device copies",
          "device", "kernels"}


def _line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _cells(m: dict) -> list[str]:
    return [w["name"] for w in m["workloads"]]


def _bench(root: Path) -> Path:
    return Path(root) / manifest.HERE.name


def top_level_and_sizes(m: dict, root: Path) -> None:
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len((Path(root) / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    assert 1 <= len(m["paths"]) <= 16
    for path in m["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert not path.endswith("_torch")
    for word in m["command"][1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in m["paths"])
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check with 24 cells must fit its time.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def entries_have_just_their_keys(m: dict, root: Path) -> None:
    cells = _cells(m)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(m["paths"][0] + "/") and (Path(root) / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((Path(root) / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert e["source"] in SOURCES and _line(e["layer"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert e["better"] in ("lower", "higher") and UNIT.match(e["unit"])
        assert set(e.get("workloads", cells)) <= set(cells)


def names_are_unique_and_plain(m: dict, root: Path) -> None:
    for group in ("configs", "workloads"):
        names = [e["name"] for e in m[group]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    metrics = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metrics) == len(set(metrics)) and all(NAME.match(n) for n in metrics)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(NAME.match(w["config"]) and NAME.match(w["traffic"]) for w in m["workloads"])
    assert {w["config"] for w in m["workloads"]} == {c["name"] for c in m["configs"]}


def files_are_named_from_names(m: dict, root: Path) -> None:
    for path in _bench(root).rglob("*"):
        rel = path.relative_to(Path(root)).as_posix()
        if "__pycache__" in rel or path.is_dir():
            continue
        assert PATH.match(rel), rel


def metrics_move_end_to_end_ones(m: dict, root: Path) -> None:
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        assert (_bench(root) / "metrics" / f"{e['name']}.py").is_file()
    # Every layer stays measured; a new one is a line, as the entries check.
    assert LAYERS <= {e["layer"] for e in m["per_layer"]}


def inverse_roofline_only_where_blocks_are_inverted(m: dict, root: Path) -> None:
    """Every cell the inverse's roofline lists runs ``"schur_direct"``; a
    ``"schur_direct"`` cell whose solve inverts other blocks than its
    reader counts is left out of the list and brings a reader of its own."""
    (gj,) = [e for e in m["per_layer"] if e["name"] == "gj_inverse_roofline_pct"]
    solvers = {w["name"]: json.loads((_bench(root) / "traffic" / f"{w['traffic']}.json")
                                     .read_text())["linear_solver"] for w in m["workloads"]}
    assert gj["workloads"] and all(solvers[c] == "schur_direct" for c in gj["workloads"])


def cell_loads_and_cross_refers(m: dict, root: Path, name: str) -> None:
    assert name in _cells(m)
    cell = manifest.load_cell(name, root=root)
    names = {e["name"] for e in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    assert cell.chips == 1
    assert cell.traffic["mesh"] == cell.config["mesh"]
    assert cell.traffic["order"] in cell.config["orders"]
    assert callable(manifest.adapter(cell).problem)
    exact, magnitude = manifest.judged_fields(cell)
    assert not set(exact) & set(magnitude)
    assert set(cell.limits) == {"points_gap", *(f"{f}_rms" for f in exact),
                                *(f"{f}_max" for f in magnitude)}
    for metric in cell.per_layer:
        assert callable(manifest.reader(cell, metric["name"]).read)


RULES = (top_level_and_sizes, entries_have_just_their_keys, names_are_unique_and_plain,
         files_are_named_from_names, metrics_move_end_to_end_ones,
         inverse_roofline_only_where_blocks_are_inverted)


def check(m: dict, root: Path) -> None:
    """Every rule on the manifest ``m`` of the checkout at ``root``."""
    for rule in RULES:
        rule(m, root)
    for name in _cells(m):
        cell_loads_and_cross_refers(m, root, name)
