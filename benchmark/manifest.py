"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (its sizes and settings, the
path the manifest gives), with ``configs/<name>.py`` beside it (the call
into the program) and ``configs/<name>_reference.py`` (the closed-form
solution ``FIELDS`` and, where it names any, ``MAGNITUDE_FIELDS``: output
fields whose exact value is zero; it imports nothing of the program).  A
traffic mix is ``traffic/<name>.json``; a cell's limits are
``workloads/<cell>.json``; a per-layer metric is read by
``metrics/<metric>.py``, whose ``read(run)`` returns a number or None.
Adding any of them adds files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One entry of ``workloads``, with everything it names loaded."""

    name: str
    root: Path
    config_name: str
    config_path: Path
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list
    per_layer: list

    @property
    def bench(self) -> Path:
        return self.root / HERE.name


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    manifest = load_manifest(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(by_name)}")
    entry = by_name[name]
    config_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    bench = root / HERE.name
    end_to_end = [m for m in manifest["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [
        m for m in manifest["per_layer"]
        if m["moves"] in moved and _reports(m, name)
    ]
    cell_file = json.loads((bench / "workloads" / f"{name}.json").read_text())
    return Cell(
        name=name,
        root=root,
        config_name=entry["config"],
        config_path=root / config_entry["file"],
        config=json.loads((root / config_entry["file"]).read_text()),
        traffic_name=entry["traffic"],
        traffic=json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=cell_file["limits"],
        chips=int(entry["chips"]),
        end_to_end=end_to_end,
        per_layer=per_layer,
    )


def load_module(path: Path):
    """The module of the Python file at ``path``, imported by path."""
    name = "bench_" + re.sub(r"\W", "_", Path(path).stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adapter(cell: Cell):
    """The configuration's call into the program."""
    return load_module(cell.config_path.with_suffix(".py"))


def reference(cell: Cell):
    """The configuration's closed-form solution (``FIELDS``)."""
    path = cell.config_path
    return load_module(path.with_name(f"{path.stem}_reference.py"))


def judged_fields(cell: Cell) -> tuple[dict, tuple]:
    """The fields ``check.readings`` holds a cell's answers to: those with a
    closed form (name to function), and those held by magnitude (names)."""
    module = reference(cell)
    return module.FIELDS, tuple(getattr(module, "MAGNITUDE_FIELDS", ()))


def reader(cell: Cell, metric: str):
    return load_module(cell.bench / "metrics" / f"{metric}.py")
