"""Runs a gallery script of the JAX package (``examples/``) and its port
(``examples_torch/``) on the CPU and compares what they produce.

Each run records every grid that ``solve_system_2d`` returns (through a
wrapper on the package's entry point) and every ``report`` call at full
precision (through the script module's ``report``).  The two runs must
give the same report titles, the same values within an absolute
tolerance, and the same point data, field by field, within the tolerance
of the field's largest magnitude.

Imported by the ``tests/test_torch_gallery_*.py`` files.  The port's
scripts run with ``MFV2D_EXAMPLES_DEVICE=cpu`` and figures off; the JAX
scripts on their one CPU device.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import torch

os.environ["MFV2D_EXAMPLES_DEVICE"] = "cpu"
os.environ["MFV2D_EXAMPLES_FIGURES"] = "0"

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Direct solves agree to round-off; a Krylov solve to its stopping
# tolerance.
DIRECT_TOL = 1e-10
KRYLOV_TOL = 1e-8
# The smallest field scale, relative to the grid's largest field, at which
# a field is held relative to itself.
ROUND_OFF_FLOOR = 1e-2


def load_script(package_dir: str, rel: str):
    """The module of ``<package_dir>/<rel>`` under a name of its own (its
    ``main`` does not run)."""
    path = ROOT / package_dir / rel
    name = f"_gallery_{package_dir}_{rel.replace('/', '_').removesuffix('.py')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def recording(module, package, entry: str = "solve_system_2d"):
    """Record the report calls of the script ``module`` and the grids that
    ``package``'s ``entry`` (a function the script calls as an attribute
    of ``package``, or of ``module`` itself) returns, in call order."""
    reports, grids = [], []
    saved_report, saved_entry = module.report, getattr(package, entry)

    def report(title, **values):
        reports.append((title, {k: float(v) for k, v in values.items()}))

    def entry_fn(*args, **kwargs):
        out = saved_entry(*args, **kwargs)
        grids.append(list(out[0]) if isinstance(out, tuple) else [out])
        return out

    module.report = report
    setattr(package, entry, entry_fn)
    try:
        yield reports, grids
    finally:
        module.report = saved_report
        setattr(package, entry, saved_entry)


def run_script(package_dir: str, rel: str, call=None, entry: str = "solve_system_2d"):
    """The reports and grids of a script of ``package_dir`` (``examples``,
    the JAX package's, or ``examples_torch``, the port's, in one thread).
    ``call(module)`` runs it in place of its ``main`` (at another size, or a
    rank's ``run``); ``entry`` names the function whose grids are recorded:
    the package's ``solve_system_2d``, or else a function of the script."""
    if package_dir == "examples_torch":
        torch.set_num_threads(1)
    module = load_script(package_dir, rel)
    owner = module
    if entry == "solve_system_2d":
        owner = importlib.import_module("mfv2d_tpu" if package_dir == "examples" else "mfv2d_torch")
    with recording(module, owner, entry) as (reports, grids):
        (call or (lambda m: m.main()))(module)
    return reports, grids


def run_jax(rel: str, call=None, entry: str = "solve_system_2d"):
    return run_script("examples", rel, call, entry)


def run_port(rel: str, call=None, entry: str = "solve_system_2d"):
    return run_script("examples_torch", rel, call, entry)


def compare_reports(port, jax, tol: float, titles_only=()) -> None:
    """The same titles in the same order; each value within ``tol``
    (absolute), but for the titles in ``titles_only``."""
    assert [t for t, _ in port] == [t for t, _ in jax]
    for (title, mine), (_, ref) in zip(port, jax):
        assert mine.keys() == ref.keys(), title
        if title in titles_only:
            continue
        for key, value in ref.items():
            assert abs(mine[key] - value) <= tol, (title, key, mine[key], value)


def compare_grids(port, jax, tol: float, calls=None) -> None:
    """Every grid of every call (of the calls indexed in ``calls`` where
    given):
    the same points, and each point-data field within ``tol`` of its
    largest magnitude in the JAX package's grid.  A field under
    ``ROUND_OFF_FLOOR`` of the grid's largest field is held to ``tol`` of
    that floor: its exact value is zero (Stokes's divergence, 1e-15 of the
    velocity), so what it holds is the round-off of the larger fields."""
    assert len(port) == len(jax)
    assert port, "the script returned no grid"
    for i, (mine_call, ref_call) in enumerate(zip(port, jax)):
        if calls is not None and i not in calls:
            continue
        assert len(mine_call) == len(ref_call), i
        for mine, ref in zip(mine_call, ref_call):
            np.testing.assert_allclose(mine.points, ref.points, rtol=0, atol=1e-13)
            assert mine.point_data.keys() == ref.point_data.keys(), i
            grid_scale = max(float(np.abs(v).max()) for v in ref.point_data.values())
            for name, want in ref.point_data.items():
                want = np.asarray(want)
                scale = max(float(np.abs(want).max()), ROUND_OFF_FLOOR * grid_scale)
                gap = float(np.abs(np.asarray(mine.point_data[name]) - want).max())
                assert gap <= tol * scale, (i, name, gap, scale)
