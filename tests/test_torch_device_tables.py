"""The device copies of the constant host tables (mfv2d_torch.ops.device_tables).

A table is uploaded at its first request in a dtype on a device and served
from that copy after it: a second assembly, residual or solve, on the same
batch or on a new batch of the same orders, uploads nothing (counted at the
cache) and gives bitwise the same answer.  A fused plan's copies go with the
plan, and no solve writes a cached tensor in place.  Parity with the JAX
package is held by the other port tests, which run through the same cache.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import mfv2d_torch as mf
from mfv2d_torch.compiler import CompiledSystem
from mfv2d_torch.config import config
from mfv2d_torch.evaluation import (
    ElementBatch,
    compute_element_matrices,
    compute_element_vectors,
    evaluate_static_fields,
)
from mfv2d_torch.models import flow, poisson
from mfv2d_torch.ops import device_tables
from mfv2d_torch.ops import fused_assembly
from mfv2d_torch.ops.basis import FemCache
from mfv2d_torch.ops.kernels import mass_edge
from mfv2d_torch.ops.mass import tensor_basis

torch.set_num_threads(1)

ORDERS = (3, 4)
BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
SYSTEMS = {
    "mixed_poisson": lambda: poisson.mixed_poisson().system,
    "navier_stokes": lambda: flow.navier_stokes(10.0).system,
}


def _batch(seed: int = 0, e: int = 5) -> ElementBatch:
    rng = np.random.default_rng(seed)
    corners = np.tile(BASE, (e, 1, 1)) + 0.08 * rng.normal(size=(e, 4, 2))
    return ElementBatch(FemCache(3).get_basis2d(*ORDERS), corners, "cpu")


def _assemble(system, compiled, batch, dofs):
    statics = evaluate_static_fields(batch, compiled.fields)
    forms = system.unknown_forms
    out = [compute_element_matrices(forms, compiled.lhs_blocks, batch, dofs, statics)]
    out.append(compute_element_vectors(forms, compiled.lhs_blocks, batch, dofs, statics))
    if compiled.rhs_blocks is not None:
        out.append(compute_element_vectors(forms, compiled.rhs_blocks, batch, dofs, statics))
    return out


@pytest.fixture
def assembly_settings(request):
    fused, sum_factorization = request.param
    old = config.fused_assembly, config.sum_factorization
    config.fused_assembly, config.sum_factorization = fused, sum_factorization
    yield
    config.fused_assembly, config.sum_factorization = old


@pytest.mark.parametrize(
    "assembly_settings",
    [(True, "never"), (True, "always"), (False, "never"), (False, "always")],
    ids=["fused", "fused-factored", "stack", "stack-factored"],
    indirect=True,
)
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_warm_assembly_uploads_nothing(name, assembly_settings):
    """A second assembly and set of residuals, on the same batch and on a
    new batch of the same orders, uploads no table and is bitwise equal."""
    system = SYSTEMS[name]()
    compiled = CompiledSystem(system)
    batch = _batch()
    n = system.unknown_forms.total_size(*ORDERS)
    dofs = torch.tensor(np.random.default_rng(1).normal(size=(batch.n_elements, n)))

    device_tables.clear()
    device_tables.uploads = 0
    first = _assemble(system, compiled, batch, dofs)
    assert device_tables.uploads > 0

    for again in (batch, _batch()):
        device_tables.uploads = 0
        second = _assemble(system, compiled, again, dofs)
        assert device_tables.uploads == 0
        assert all(torch.equal(a, b) for a, b in zip(first, second, strict=True))


def test_batches_of_one_order_share_their_tables():
    """Batches of the same orders share one TensorBasis, so M1's padded table,
    weights and tile codes are the same tensors for both."""
    one, two = _batch(0), _batch(1)
    assert one.tb is two.tb
    assert tensor_basis(FemCache(0).get_basis2d(*ORDERS, 6, 7)) is one.tb
    assert tensor_basis(FemCache(0).get_basis2d(*ORDERS, 6, 8)) is not one.tb
    tb = one.tb
    plan = mass_edge.element_plan(tb.bh.shape[0], tb.bv.shape[0], tb.w.size, torch.float64)
    det_one, det_two = one.jac.det, two.jac.det
    device_tables.clear()
    device_tables.uploads = 0
    first = mass_edge._device_tables(tb, plan, det_one)
    assert device_tables.uploads == 3
    second = mass_edge._device_tables(two.tb, plan, det_two)
    assert all(a is b for a, b in zip(first, second, strict=True))
    assert first[1] is tb.tensor("w", det_one)
    assert device_tables.uploads == 3
    np.testing.assert_array_equal(first[0].numpy(), mass_edge.padded_table(tb, plan))
    assert first[2].dtype == torch.int32 and first[2].tolist() == list(plan.tiles)


def test_dtypes_and_devices_get_separate_entries():
    tb = _batch().tb
    device_tables.clear()
    device_tables.uploads = device_tables.upload_bytes = 0
    f64 = torch.zeros(1, dtype=torch.float64)
    f32 = torch.zeros(1, dtype=torch.float32)
    meta = torch.zeros(1, dtype=torch.float64, device="meta")
    w64, w32, w_meta = (tb.tensor("w", like) for like in (f64, f32, meta))
    assert device_tables.uploads == 3
    assert (w64.dtype, w32.dtype, w_meta.device.type) == (torch.float64, torch.float32, "meta")
    assert torch.equal(w64, torch.tensor(tb.w))
    assert torch.equal(w32, torch.tensor(tb.w, dtype=torch.float32))
    assert tb.tensor("w", f64) is w64 and tb.tensor("w", f32) is w32
    assert tb.tensor("w", meta) is w_meta
    assert device_tables.uploads == 3
    assert device_tables.resident_bytes("meta") == w_meta.nbytes
    assert device_tables.resident_bytes("cpu") == w64.nbytes + w32.nbytes
    assert device_tables.upload_bytes == w64.nbytes + w32.nbytes + w_meta.nbytes


def test_plan_tables_go_with_the_plan():
    """Dropping the fused plans (clearing _cached_plan) frees their copies."""
    system = SYSTEMS["navier_stokes"]()
    compiled = CompiledSystem(system)
    batch = _batch()
    n = system.unknown_forms.total_size(*ORDERS)
    dofs = torch.tensor(np.random.default_rng(1).normal(size=(batch.n_elements, n)))
    old = config.fused_assembly
    config.fused_assembly = True
    try:
        _assemble(system, compiled, batch, dofs)
        plans = [
            fused_assembly.try_plan(block, batch)
            for row in compiled.lhs_blocks
            for block in row
            if block is not None
        ]
        plan_tensors = [t for plan in plans if plan is not None for t in plan.tables.tensors()]
        assert plan_tensors
        plan_bytes = sum(t.nbytes for t in plan_tensors)
        before = device_tables.resident_bytes()
        refs = [weakref.ref(t) for t in plan_tensors]
        del plans, plan_tensors
        fused_assembly._cached_plan.cache_clear()
        gc.collect()
        assert all(ref() is None for ref in refs)
        assert device_tables.resident_bytes() == before - plan_bytes
        # The basis's tables stay: a new plan uploads only its own.
        device_tables.uploads = 0
        _assemble(system, compiled, batch, dofs)
        assert device_tables.resident_bytes() == before
        assert device_tables.uploads == len(refs)
    finally:
        config.fused_assembly = old


def _mixed_poisson_solve():
    model = poisson.mixed_poisson()
    mesh = mf.examples.unit_square_mesh(4, 4, 3)
    grids, stats, _ = mf.solve_system_2d(
        mesh, mf.SystemSettings(model.system), recon_order=3, device="cpu"
    )
    return grids[-1], stats


def _navier_stokes_solve(method: str):
    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(3, 3, 3)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    grids, stats, _ = mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(20, 1e-10, 0.0),
            relaxation=0.7 if method == "picard" else 1.0,
            method=method,
        ),
        recon_order=3,
        device="cpu",
    )
    return grids[-1], stats


SOLVES = {
    "mixed_poisson_direct": _mixed_poisson_solve,
    "navier_stokes_picard": lambda: _navier_stokes_solve("picard"),
    "navier_stokes_newton": lambda: _navier_stokes_solve("newton"),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_second_solve_uploads_nothing(name):
    """A whole solve run twice: the second run uploads no table (in assembly,
    Picard residuals or Newton Jacobians) and its answer is bitwise equal."""
    device_tables.clear()
    device_tables.uploads = 0
    grid, stats = SOLVES[name]()
    assert device_tables.uploads > 0
    device_tables.uploads = 0
    grid2, stats2 = SOLVES[name]()
    assert device_tables.uploads == 0
    np.testing.assert_array_equal(stats2.iter_history, stats.iter_history)
    assert grid2.point_data.keys() == grid.point_data.keys()
    for key in grid.point_data:
        np.testing.assert_array_equal(grid2.point_data[key], grid.point_data[key])


def test_picard_leaves_cached_tables_unchanged():
    """Cached tensors are shared and read-only: a Navier-Stokes Picard solve
    writes none of them in place (their checksums and version counters are
    the same after it)."""
    device_tables.clear()
    _navier_stokes_solve("picard")
    tensors = device_tables.cached_tensors()
    assert tensors
    sums = [t.double().sum().item() for t in tensors]
    copies = [t.clone() for t in tensors]
    _navier_stokes_solve("picard")
    assert all(t._version == 0 for t in tensors)
    assert [t.double().sum().item() for t in tensors] == sums
    assert all(torch.equal(t, c) for t, c in zip(tensors, copies, strict=True))
