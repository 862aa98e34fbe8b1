"""The PyTorch port and its gallery stand alone: no JAX, no mfv2d_tpu, and
its host copies render the golden compiler strings byte for byte."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mfv2d_torch"
FORBIDDEN = ("jax", "jaxlib", "mfv2d_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "lazy_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_sources_import_no_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "examples_torch").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT))
)
def test_gallery_sources_import_no_jax(path):
    """The port's gallery imports neither JAX nor the JAX package, nor the
    JAX gallery (``examples``, whose scripts import its ``common``)."""
    assert not _imported_roots(path) & {*FORBIDDEN, "examples", "common"}


def test_import_leaves_no_jax_modules():
    code = (
        "import sys, mfv2d_torch, mfv2d_torch.solve_system_2d, "
        "mfv2d_torch.ops.kernels.mass_edge, mfv2d_torch.ops.kernels.gj_inverse, "
        "mfv2d_torch.solver.iterative, mfv2d_torch.solver.fused, "
        "mfv2d_torch.models.transport, mfv2d_torch.interop, mfv2d_torch.checkpoint, "
        "mfv2d_torch.solver.krylov, mfv2d_torch.parallel.sharding, mfv2d_torch.parallel.vms\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_compiler_copies_render_golden_strings():
    import mfv2d_torch.compiler as compiler
    import mfv2d_torch.kform as kform
    import mfv2d_torch.system as system

    sys.path.insert(0, str(ROOT / "tests" / "golden"))
    try:
        from make_compiler_fixtures import render
    finally:
        sys.path.pop(0)
    golden = (ROOT / "tests" / "golden" / "reference_compiler_strings.txt").read_text()
    assert render(kform, system, compiler.system_as_string) == golden
