"""The port's multi-device gallery scripts (``examples_torch/parallel``)
against the JAX package's (``examples/parallel``).

The port's ``run`` goes through 2 ``gloo`` ranks on the CPU, spawned by
``test_torch_parallel.run_ranks``; the JAX script runs here on one CPU
device, so its titles say ``devices=1`` where the port's say
``devices=2``.  Report values agree to 1e-8 and every rank's grids to 1e-8
of each field's scale (both solve through Krylov loops).

The JAX package's sharded VMS solve takes over 3 minutes on the CPU at any
size (196 s at the script's 4x4 p=4, 221 s at 2x2 p=4), so
``multichip_vms.py`` is held against the JAX script at its own size in a
case marked ``slow``.  In tier-1 it is held against the JAX script's
report as ``chip_smoke.py`` pins it (``JAX_GALLERY``, written by
``tools/gallery_reference.py``), and its grids against the JAX package's
single-device VMS solve of the same problem through ``solve_system_2d``.
"""

import types

import numpy as np
import pytest
from chip_smoke import JAX_GALLERY
from gallery_harness import KRYLOV_TOL, ROOT, compare_grids, compare_reports, run_jax, run_port

from test_torch_parallel import run_ranks

WORLD = 2
# The function each script passes its grids through.
ENTRY = {
    "parallel/multichip_poisson.py": "solve_system_2d",
    "parallel/multichip_vms.py": "reconstruct_mesh_from_solution",
}


def _run_on_rank(rel, mesh):
    """A rank: the port script's ``run`` on ``mesh``, its reports and grids."""
    reports, grids = run_port(rel, call=lambda m: m.run(mesh), entry=ENTRY[rel])
    plain = [
        [types.SimpleNamespace(points=g.points, point_data=dict(g.point_data)) for g in call]
        for call in grids
    ]
    return {"reports": reports, "grids": plain}


def case_multichip_poisson(mesh, tmp):
    return _run_on_rank("parallel/multichip_poisson.py", mesh)


def case_multichip_vms(mesh, tmp):
    return _run_on_rank("parallel/multichip_vms.py", mesh)


CASES = {
    "parallel/multichip_poisson.py": case_multichip_poisson,
    "parallel/multichip_vms.py": case_multichip_vms,
}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    return run_ranks(WORLD, list(CASES), tmp_path_factory.mktemp("gallery"), table=CASES)


def _jax_on_one_device(rel, monkeypatch):
    import jax

    devices = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *args, **kwargs: devices[:1])
    return run_jax(rel, entry=ENTRY[rel])


def _check(port_runs, rel, jax_reports, jax_grids=None):
    ranks = [r[rel] for r in port_runs]
    want = [(t.replace("devices=1", f"devices={WORLD}"), v) for t, v in jax_reports]
    compare_reports(ranks[0]["reports"], want, KRYLOV_TOL)
    assert all(not r["reports"] for r in ranks[1:]), "only rank 0 reports"
    for r in ranks:
        if jax_grids is not None:
            compare_grids(r["grids"], jax_grids, KRYLOV_TOL)
        compare_grids(r["grids"], ranks[0]["grids"], 1e-13)


def test_multichip_poisson_matches_jax(port_runs, monkeypatch):
    rel = "parallel/multichip_poisson.py"
    _check(port_runs, rel, *_jax_on_one_device(rel, monkeypatch))


@pytest.mark.slow
def test_multichip_vms_matches_jax(port_runs, monkeypatch):
    rel = "parallel/multichip_vms.py"
    _check(port_runs, rel, *_jax_on_one_device(rel, monkeypatch))


def test_multichip_vms_matches_the_pinned_jax_values(port_runs):
    rel = "parallel/multichip_vms.py"
    _check(port_runs, rel, JAX_GALLERY[rel])


def test_multichip_vms_matches_the_single_device_jax_solve(port_runs):
    """The script's problem (4x4 p=4, +2 fine, matrix-free) through the JAX
    package's single-device ``solve_system_2d``: the same u and q on every
    rank to 1e-8 of their scale, the same L2 error, and one Picard
    iteration fewer (the sharded branch counts residual evaluations)."""
    import mfv2d_tpu as jf

    from test_torch_parallel_vms import _model, _vms, u_exact

    model, symmetric = _model(jf)
    sols, stats, _ = jf.solve_system_2d(
        jf.examples.unit_square_mesh(4, 4, 4),
        jf.SystemSettings(model.system),
        jf.SolverSettings(jf.ConvergenceSettings(40, 1e-9, 0)),
        vms_settings=_vms(jf, model, symmetric),
        recon_order=6,
    )
    ref = sols[-1]
    x, y = ref.points[:, 0], ref.points[:, 1]
    ref_l2 = float(np.sqrt(np.mean((ref.point_data["u"] - u_exact(x, y)) ** 2)))
    ranks = [r["parallel/multichip_vms.py"] for r in port_runs]
    (_, values), = ranks[0]["reports"]
    assert abs(values["l2_u"] - ref_l2) <= KRYLOV_TOL
    assert values["picard_iters"] == int(stats.iter_history[-1]) + 1
    assert values["final_residual"] <= 1e-9
    fields = types.SimpleNamespace(
        points=ref.points, point_data={k: ref.point_data[k] for k in ("u", "q")}
    )
    for r in ranks:
        compare_grids(r["grids"], [[fields]], KRYLOV_TOL)


def test_spawn_ranks_runs_a_script_and_fails_with_its_rank(capfd):
    """The scripts' own entry point: one gloo rank on the CPU runs the
    script's ``run``; a rank that raises fails the call with its traceback."""
    from examples_torch.common import load_script, run_script, spawn_ranks

    script = ROOT / "examples_torch" / "parallel" / "multichip_poisson.py"
    load_script(script).main()
    assert "[multichip_poisson p=4 devices=1]" in capfd.readouterr().out
    with pytest.raises(RuntimeError, match="rank 0 of 1 failed:(.|\\n)*AttributeError"):
        spawn_ranks(run_script, script, "no_such_job")
