"""The port against the JAX package at p = 16.

Navier-Stokes Re=10 on a 1x1 mesh at p = 16 has element blocks of
n = 289 + 544 + 256 = 1089, the first model size whose element inverses
take the streamed route's clustered panel on the card (a cluster of three
blocks a matrix, see ``mfv2d_torch.ops.kernels.gj_inverse.launch_plan``).
Here, on the CPU, the port's blocks are held against the JAX package's to
1e-12, and two Picard iterations through ``linear_solver="schur_direct"``
(element inverses, then the trace system) to 1e-10.  Most of the JAX
package's time is compilation (about 50 s on one CPU thread), so the file
keeps to these two tests.
"""

import importlib

import numpy as np
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.models import flow as tflow
from mfv2d_torch.ops.kernels import gj_inverse as kernel
from mfv2d_tpu.models import flow as jflow

torch.set_num_threads(1)

P = 16
jsolve_mod = importlib.import_module("mfv2d_tpu.solve_system_2d")
tsolve_mod = importlib.import_module("mfv2d_torch.solve_system_2d")


def rel(mine, ref) -> float:
    mine = mine.cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    ref = np.asarray(ref)
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


def _blocks(mf, discretize_mesh, fem_cache, evaluator_type, compiled_type, flow, **device):
    system = flow.navier_stokes(10.0).system
    compiled = compiled_type(system)
    mesh = mf.examples.unit_square_mesh(1, 1, P)
    disc = discretize_mesh(mesh, system.unknown_forms, fem_cache(3), **device)
    spec = disc.form_spec if device else system.unknown_forms
    evaluator = evaluator_type(spec, compiled, disc)
    return np.asarray(evaluator.element_matrices(compiled.lhs_blocks)[0])


def test_navier_stokes_p16_blocks_match_jax():
    from mfv2d_torch.compiler import CompiledSystem as TCompiled
    from mfv2d_torch.ops.basis import FemCache as TFemCache
    from mfv2d_torch.solver.discretization import discretize_mesh as tdiscretize
    from mfv2d_torch.solver.solve import SystemEvaluator as TEvaluator
    from mfv2d_tpu.compiler import CompiledSystem as JCompiled
    from mfv2d_tpu.ops.basis import FemCache as JFemCache
    from mfv2d_tpu.solver.discretization import discretize_mesh as jdiscretize
    from mfv2d_tpu.solver.solve import SystemEvaluator as JEvaluator

    mine = _blocks(tf, tdiscretize, TFemCache, TEvaluator, TCompiled, tflow, device="cpu")
    ref = _blocks(jf, jdiscretize, JFemCache, JEvaluator, JCompiled, jflow)
    assert mine.shape == ref.shape == (1, 1089, 1089)
    assert kernel.launch_plan(1089, torch.float64).blocks > 1
    assert rel(mine, ref) <= 1e-12


def _solve(mf, module, flow, monkeypatch):
    """Two Picard iterations of Navier-Stokes Re=10, 1x1, p=16, through
    static condensation; the solution vector and the statistics."""
    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(1, 1, P)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    captured = []
    original = module.reconstruct_mesh_from_solution

    def capture(disc, recon_order, solution, *args):
        captured.append(np.array(solution))
        return original(disc, recon_order, solution, *args)

    monkeypatch.setattr(module, "reconstruct_mesh_from_solution", capture)
    on_cpu = {"device": "cpu"} if mf is tf else {}
    _, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(2, 1e-8, 0.0), relaxation=0.7, linear_solver="schur_direct"
        ),
        recon_order=4,
        **on_cpu,
    )
    monkeypatch.undo()
    return captured[-1], stats


def test_navier_stokes_p16_schur_direct_matches_jax(monkeypatch):
    jsol, jstats = _solve(jf, jsolve_mod, jflow, monkeypatch)
    tsol, tstats = _solve(tf, tsolve_mod, tflow, monkeypatch)
    assert int(jstats.iter_history[-1]) == int(tstats.iter_history[-1]) == 2
    assert np.all(np.isfinite(tsol))
    assert rel(tsol, jsol) <= 1e-10
