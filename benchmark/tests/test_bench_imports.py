"""What the command imports: never JAX or the JAX package, compared by
whole top-level names; and the reference side imports nothing of the
program."""

import ast
import json
import subprocess
import sys

from conftest import BENCH, ROOT

import run

FORBIDDEN = {"jax", "jaxlib", "flax", "mfv2d_tpu"}


def test_no_source_imports_them():
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, path


def _modules_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
        timeout=300,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_a_run_imports():
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import run, harness, manifest, device_trace
import torch.profiler
import mfv2d_torch as mf
from mfv2d_torch.ops.kernels import gj_inverse, mass_edge
from mfv2d_torch.models import flow, poisson
for name in [w["name"] for w in manifest.load_manifest()["workloads"]]:
    cell = manifest.load_cell(name)
    manifest.adapter(cell); manifest.reference(cell)
    for m in cell.per_layer:
        manifest.reader(cell, m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _modules_after(code)
    assert "mfv2d_torch" in top and not top & FORBIDDEN


def test_reference_side_imports_no_program():
    refs = sorted(p.stem for p in (BENCH / "configs").glob("*_reference.py"))
    code = f"""
import json, sys
sys.path[:0] = [{str(BENCH / "configs")!r}, {str(BENCH)!r}]
import check, roofline, traffic
{"; ".join(f"import {r}" for r in refs)}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _modules_after(code)
    assert refs and not top & (FORBIDDEN | {"mfv2d_torch", "torch"})


def test_forbidden_names_match_whole(monkeypatch):
    for name in ("mfv2d_tpu_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not {"mfv2d_tpu_extra", "jaxtyping", "flaxen"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
