"""Solves with VMS in the port against the JAX package.

Counterparts of tests/test_vms.py through ``solve_system_2d``: the same
problem runs through both packages' public entry point, on the CPU in f64,
through the direct-LU and the matrix-free Green's operator.  Solutions must
agree to 1e-10 relative with equal Picard iterations; fine scales to 1e-8
relative to the JAX package's largest |vms|, or to 1e-13 absolute where the
JAX package's fine scales are round-off (below 1e-10: the resolved mixed
Poisson and the nonlinear flow, whose advection's linear part is the
symmetric operator itself).  That floor holds the matrix-free Green's
operator to the accuracy of the JAX package's LU solves: without its one
refinement round per element apply the port's fine scales of the
nonlinear flow lie 2.6e-13 from the JAX package's.  The linear
advection-diffusion problem has fine scales of order one.
"""

import importlib

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.models import transport as ttransport
from mfv2d_tpu.models import transport as jtransport

torch.set_num_threads(1)

jsolve_mod = importlib.import_module("mfv2d_tpu.solve_system_2d")
tsolve_mod = importlib.import_module("mfv2d_torch.solve_system_2d")


def u_exact(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def q_exact(x, y):
    return np.stack(
        (
            -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def poisson_source(x, y):
    return -(np.pi**2) / 2 * u_exact(x, y)


def flow_source(x, y):
    return np.sum(q_exact(x, y) ** 2, axis=-1) + np.pi**2 * u_exact(x, y) / 2


def wind(x, y):
    return np.stack((np.ones_like(x), 0.5 * np.ones_like(x)), axis=-1)


def advdif_source(x, y):
    return np.exp(x) * np.sin(np.pi * y)


def _mixed_poisson(mf, transport):
    """tests/test_vms.py's resolved mixed Poisson: 3x3, p=3, +2."""
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    v, p = u.weight, q.weight
    system = mf.KFormSystem(
        p.derivative @ u - p @ q == p ^ u_exact,
        v @ q.derivative == -(v @ poisson_source),
    )
    return (
        mf.examples.unit_square_mesh(3, 3, 3),
        mf.SystemSettings(system, over_integration_order=3),
        mf.SolverSettings(mf.ConvergenceSettings(20, 1e-8, 0)),
        dict(symmetric_system=system, nonsymmetric_system=system, order_increase=2),
        mf.ConvergenceSettings(10, 1e-10, 1e-8),
        6,
    )


def _advection_diffusion(mf, transport):
    """Linear advection-diffusion (nu = 0.1, a constant wind) with its
    diffusion as the symmetric system: 3x3, p=2, +1."""
    model = transport.linear_advection_diffusion(0.1, wind, u_exact, advdif_source)
    u, q = model.u, model.q
    symmetric = mf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == q.weight ^ u_exact,
        0.1 * (u.weight @ q.derivative) == -(u.weight @ advdif_source),
    )
    return (
        mf.examples.unit_square_mesh(3, 3, 2),
        mf.SystemSettings(model.system, over_integration_order=3),
        mf.SolverSettings(mf.ConvergenceSettings(40, 1e-10, 0)),
        dict(symmetric_system=symmetric, nonsymmetric_system=model.system, order_increase=1),
        mf.ConvergenceSettings(10, 1e-12, 1e-12),
        4,
    )


def _nonlinear_flow(mf, transport):
    """tests/test_vms.py's nonlinear flow (nu = -1): 4x4, p=3, +2, through
    static condensation."""
    model = transport.nonlinear_flow(-1.0, u_exact, flow_source)
    u, q = model.u, model.q
    symmetric = mf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == q.weight ^ u_exact,
        -1.0 * (u.weight @ q.derivative) == -(u.weight @ flow_source),
    )
    return (
        mf.examples.unit_square_mesh(4, 4, 3),
        mf.SystemSettings(model.system, over_integration_order=3),
        mf.SolverSettings(mf.ConvergenceSettings(40, 1e-9, 0), linear_solver="schur_direct"),
        dict(symmetric_system=symmetric, nonsymmetric_system=model.system, order_increase=2),
        mf.ConvergenceSettings(10, 1e-10, 1e-8),
        6,
    )


CASES = {
    "mixed_poisson": _mixed_poisson,
    "advection_diffusion": _advection_diffusion,
    "nonlinear_flow": _nonlinear_flow,
}


def _solve(mf, monkeypatch, case, time_settings=None, fine=None, **vms_kw):
    """The package's grids, statistics and the DoF vectors it reconstructed
    (captured at reconstruct_mesh_from_solution)."""
    module = tsolve_mod if mf is tf else jsolve_mod
    transport = ttransport if mf is tf else jtransport
    mesh, settings, solver, systems, case_fine, recon = CASES[case](mf, transport)
    fine = case_fine if fine is None else mf.ConvergenceSettings(*fine)
    captured = []
    original = module.reconstruct_mesh_from_solution

    def capture(disc, recon_order, solution, *args):
        captured.append(np.array(solution))
        return original(disc, recon_order, solution, *args)

    monkeypatch.setattr(module, "reconstruct_mesh_from_solution", capture)
    if time_settings is not None:
        forms = {f.label: f for f in settings.system.unknown_forms.iter_forms()}
        time_settings = mf.TimeSettings(*time_settings, {forms["u"].weight: forms["u"]})
    grids, stats, _ = mf.solve_system_2d(
        mesh,
        settings,
        solver,
        time_settings=time_settings,
        vms_settings=mf.VMSSettings(**systems, fine_scale_convergence=fine, **vms_kw),
        recon_order=recon,
        **({"device": "cpu"} if mf is tf else {}),
    )
    monkeypatch.undo()
    return grids, stats, captured


def _rel(mine, ref) -> float:
    """Largest difference relative to the reference's largest entry (plain
    difference for a zero reference, such as the initial state)."""
    scale = float(np.abs(ref).max())
    return float(np.abs(np.asarray(mine) - ref).max()) / (scale if scale else 1.0)


def _check_fine_scales(mine, ref) -> None:
    scale = float(np.abs(ref).max())
    floor = 1e-13 if scale < 1e-10 else 0.0
    assert np.all(np.isfinite(mine))
    assert float(np.abs(mine - ref).max()) <= max(1e-8 * scale, floor)


def _check_parity(tout, jout) -> None:
    (tgrids, tstats, tsol), (jgrids, jstats, jsol) = tout, jout
    assert np.array_equal(tstats.iter_history, jstats.iter_history)
    assert len(tgrids) == len(jgrids) and len(tsol) == len(jsol)
    for mine, ref in zip(tsol, jsol):
        assert _rel(mine, ref) <= 1e-10
    for tgrid, jgrid in zip(tgrids, jgrids):
        assert set(tgrid.point_data) == set(jgrid.point_data)
        for name, ref in jgrid.point_data.items():
            if name.startswith("vms-"):
                _check_fine_scales(tgrid.point_data[name], ref)
            else:
                assert _rel(tgrid.point_data[name], ref) <= 1e-10, name


@pytest.mark.parametrize("matrix_free", [False, True], ids=["direct_lu", "matrix_free"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vms_solve_matches_jax(case, matrix_free, monkeypatch):
    tout = _solve(tf, monkeypatch, case, matrix_free=matrix_free)
    jout = _solve(jf, monkeypatch, case, matrix_free=matrix_free)
    _check_parity(tout, jout)
    fine_scales = tout[0][-1].point_data["vms-u"]
    if case == "advection_diffusion":
        assert np.abs(fine_scales).max() > 0.1
    else:
        # Resolved by the coarse space: the fine scales are round-off.
        assert np.abs(fine_scales).max() < 1e-10


def test_gmres_unresolved_scales_match_fixed_point(monkeypatch):
    """The Krylov unresolved-scale solve equals the stationary iteration on
    the mixed Poisson problem, as in the JAX package's test, and the
    stationary one equals the JAX package's.  (On the advection-diffusion
    problem the stationary iteration diverges in both packages: F G' has a
    norm above one there.)"""
    gmres = _solve(tf, monkeypatch, "mixed_poisson", fine=(60, 1e-12, 1e-10))
    fixed = _solve(
        tf, monkeypatch, "mixed_poisson", fine=(60, 1e-12, 1e-10), iteration="fixed-point"
    )
    jfixed = _solve(
        jf, monkeypatch, "mixed_poisson", fine=(60, 1e-12, 1e-10), iteration="fixed-point"
    )
    _check_parity(fixed, jfixed)
    gap = gmres[0][-1].point_data["vms-u"] - fixed[0][-1].point_data["vms-u"]
    assert np.abs(gap).max() <= 1e-8
    assert _rel(gmres[2][-1], fixed[2][-1]) <= 1e-10


def test_vms_march_matches_jax(monkeypatch):
    """Two trapezoidal steps of the advection-diffusion problem with VMS:
    every sampled grid and its fine scales against the JAX package's."""
    tout = _solve(tf, monkeypatch, "advection_diffusion", time_settings=(0.1, 2))
    jout = _solve(jf, monkeypatch, "advection_diffusion", time_settings=(0.1, 2))
    assert tout[1].iter_history.shape == (2,)
    _check_parity(tout, jout)
    assert all("vms-u" in g.point_data for g in tout[0][1:])
    assert "vms-u" not in tout[0][0].point_data


def test_vms_anticipatory_strict_solve(monkeypatch):
    """Near convergence the in-loop unresolved solve runs strictly: the
    port's sequence of absolute-tolerance overrides equals the JAX
    package's, with anticipation off (every in-loop solve loosened, then the
    guarded re-solve with none) and at its default factor of 3."""
    from mfv2d_torch.solver.vms import SuyashGreenOperator as TGreen
    from mfv2d_tpu.solver.vms import SuyashGreenOperator as JGreen

    sequences = {}
    for mf, green in ((tf, TGreen), (jf, JGreen)):
        for factor in (0.0, 3.0):
            overrides = []
            original = green.compute_unresolved_contributions

            def spy(self, coarse, guess, rtol_override=None, atol_override=None):
                overrides.append(atol_override)
                return original(
                    self, coarse, guess, rtol_override=rtol_override, atol_override=atol_override
                )

            with monkeypatch.context() as m:
                m.setattr(green, "compute_unresolved_contributions", spy)
                grids, stats, _ = _solve(
                    mf, m, "nonlinear_flow", fine=(10, 1e-12, 1e-10), anticipate_factor=factor
                )
            sequences[mf.__name__, factor] = (overrides, int(stats.iter_history[-1]), grids)
    for factor in (0.0, 3.0):
        mine, iters, tgrids = sequences["mfv2d_torch", factor]
        ref, j_iters, jgrids = sequences["mfv2d_tpu", factor]
        assert iters == j_iters
        assert [o is None for o in mine] == [o is None for o in ref]
        loose = [i for i, o in enumerate(ref) if o is not None]
        assert np.allclose([mine[i] for i in loose], [ref[i] for i in loose], rtol=1e-6)
        assert _rel(tgrids[-1].point_data["u"], jgrids[-1].point_data["u"]) <= 1e-10
    seq0, it0, _ = sequences["mfv2d_torch", 0.0]
    seq3, it3, _ = sequences["mfv2d_torch", 3.0]
    assert seq0[-1] is None and all(o is not None for o in seq0[:-1])
    assert len(seq0) == it0 + 2
    assert seq3[-1] is None and len(seq3) == it3 + 1
    assert any(o is not None for o in seq3)
