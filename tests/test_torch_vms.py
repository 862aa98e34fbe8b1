"""The VMS fine-scale Green's operator of the port against the JAX package.

Counterparts of tests/test_vms.py at the operator level: both packages build
``SuyashGreenOperator`` on the same mesh and system in f64, on the CPU, and
apply it to the same seeded vectors.  G' must annihilate the coarse scales
and agree with the JAX package's to 1e-10 relative; the Galerkin product
P^T A_f P agrees with the JAX package's host triple product to 1e-12; the
device applies of a one-order mesh (the shared inclusion and the fine
advection table) agree with host CSR operators built from per-element
matrices.  The solves through the operator are in test_torch_vms_solve.py.
"""

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.compiler import CompiledSystem as TCompiled
from mfv2d_torch.ops.basis import FemCache as TCache
from mfv2d_torch.solver.discretization import discretize_mesh as t_discretize
from mfv2d_torch.solver.solve import SystemEvaluator as TEvaluator
from mfv2d_torch.solver.vms import SuyashGreenOperator as TGreen
from mfv2d_torch.solver.vms import galerkin_product
from mfv2d_tpu.compiler import CompiledSystem as JCompiled
from mfv2d_tpu.ops.basis import FemCache as JCache
from mfv2d_tpu.solver.discretization import discretize_mesh as j_discretize
from mfv2d_tpu.solver.solve import SystemEvaluator as JEvaluator
from mfv2d_tpu.solver.vms import SuyashGreenOperator as JGreen

torch.set_num_threads(1)


def _deformation(xi, eta):
    return (
        xi + 0.1 * np.sin(np.pi * xi) * np.sin(np.pi * eta),
        eta - 0.1 * np.sin(np.pi * xi) * np.sin(np.pi * eta),
    )


def _mixed_laplace(mf):
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    v, p = u.weight, q.weight
    return mf.KFormSystem(
        p @ q + p.derivative @ u == 0,
        v @ q.derivative == 0,
        sorting=lambda f: f.order,
    )


def _operator(mf, mesh, k, matrix_free=None, system=None, nonsymmetric=None):
    """(operator, discretization) of the package ``mf`` with order increase k."""
    system = _mixed_laplace(mf) if system is None else system
    nonsymmetric = system if nonsymmetric is None else nonsymmetric
    if mf is tf:
        disc = t_discretize(mesh, system.unknown_forms, TCache(order_difference=k), device="cpu")
        evaluator = TEvaluator(system.unknown_forms, TCompiled(system), disc)
        green = TGreen
    else:
        disc = j_discretize(mesh, system.unknown_forms, JCache(order_difference=k))
        evaluator = JEvaluator(system.unknown_forms, JCompiled(system), disc)
        green = JGreen
    settings = mf.VMSSettings(
        symmetric_system=system,
        nonsymmetric_system=nonsymmetric,
        order_increase=k,
        fine_scale_convergence=mf.ConvergenceSettings(10, 1e-10, 1e-10),
        matrix_free=matrix_free,
    )
    return green(system, settings, disc, evaluator, [], []), disc


def _annihilation(op, g) -> float:
    """The coarse solve of P^T A_f G' x: zero when G' has no coarse part."""
    n_fine = g.size
    fine_forcing = (op.fine_sym_mat @ np.pad(g, (0, op.fine_padding)))[:n_fine] @ op.projector_c2f
    res = op.coarse_decomp.solve(np.pad(fine_forcing, (0, op.coarse_padding)))
    return float(np.abs(res[: res.size - op.coarse_padding]).max())


def _rel(mine, ref) -> float:
    return float(np.abs(np.asarray(mine) - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize(
    ("nh", "nv", "element_order", "k"), ((3, 4, 3, 2), (2, 3, 4, 3), (2, 2, 1, 1))
)
def test_fine_green_annihilates_coarse(nh, nv, element_order, k):
    ops = [
        _operator(mf, mf.examples.unit_square_mesh(nh, nv, element_order, _deformation), k)[0]
        for mf in (tf, jf)
    ]
    assert ops[0]._dev_ops and not ops[0].matrix_free
    forcing = np.random.default_rng(0).uniform(-1, 1, int(ops[0].fine_offsets[-1]))
    g, g_jax = (op.fine_scale_greens_function(forcing) for op in ops)
    assert _annihilation(ops[0], g) < 1e-8 * max(1.0, np.max(np.abs(g)))
    assert _rel(g, g_jax) <= 1e-10
    assert np.array_equal(ops[0].fine_offsets, ops[1].fine_offsets)
    assert _rel(ops[0].fine_forcing + 1.0, ops[1].fine_forcing + 1.0) <= 1e-12


def test_fine_green_annihilates_coarse_hp_mesh():
    """A mixed-order (two-bucket) mesh: per-element projectors and host CSR
    operators instead of the shared inclusion."""
    ops = []
    for mf in (tf, jf):
        mesh = mf.examples.unit_square_mesh(2, 2, np.array([[2, 2], [3, 3]] * 2))
        op, disc = _operator(mf, mesh, 2)
        assert len(disc.buckets) > 1 and not op._dev_ops
        ops.append(op)
    forcing = np.random.default_rng(0).uniform(-1, 1, int(ops[0].fine_offsets[-1]))
    g, g_jax = (op.fine_scale_greens_function(forcing) for op in ops)
    assert _annihilation(ops[0], g) < 1e-8 * max(1.0, np.max(np.abs(g)))
    assert _rel(g, g_jax) <= 1e-10
    assert _rel(ops[0].projector_c2f.toarray(), ops[1].projector_c2f.toarray()) <= 1e-12


@pytest.mark.parametrize("orders", [3, np.array([[2, 2], [3, 3]] * 2)], ids=["uniform", "hp"])
def test_matrix_free_greens_matches_splu(orders):
    """The element-blocked saddles through static condensation give the G'
    of the sparse LU, in the port and in the JAX package."""
    results = {}
    for mf in (tf, jf):
        for matrix_free in (False, True):
            mesh = mf.examples.unit_square_mesh(3, 3, orders) if np.ndim(orders) == 0 else (
                mf.examples.unit_square_mesh(2, 2, orders)
            )
            op, _ = _operator(mf, mesh, 2, matrix_free=matrix_free)
            assert op.matrix_free == matrix_free
            x = np.random.default_rng(3).uniform(-1, 1, int(op.fine_offsets[-1]))
            results[mf.__name__, matrix_free] = op.fine_scale_greens_function(x)
    lu = results["mfv2d_torch", False]
    assert _rel(results["mfv2d_torch", True], lu) <= 1e-10
    assert _rel(lu, results["mfv2d_tpu", False]) <= 1e-10
    assert _rel(results["mfv2d_torch", True], results["mfv2d_tpu", True]) <= 1e-10


def test_galerkin_product_matches_host_triple_product():
    """P^T A_f P on the port's device (here the CPU) against the JAX
    package's host product of its own fine blocks and inclusion."""
    from mfv2d_torch.evaluation import ElementBatch as TBatch
    from mfv2d_torch.evaluation import compute_element_matrices, reference_inclusion_matrix
    from mfv2d_tpu.evaluation import ElementBatch as JBatch
    from mfv2d_tpu.evaluation import jit_element_matrices
    from mfv2d_tpu.evaluation import reference_inclusion_matrix as j_inclusion

    p, dk = 3, 2
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)[None] + 0.2 * (
        np.random.default_rng(12).uniform(-1, 1, (6, 4, 2))
    )
    t_sys, j_sys = _mixed_laplace(tf), _mixed_laplace(jf)
    t_blocks = compute_element_matrices(
        t_sys.unknown_forms,
        TCompiled(t_sys).lhs_blocks,
        TBatch(TCache(3).get_basis2d(p + dk, p + dk, p + 3, p + 3), corners, "cpu"),
    )
    j_blocks = np.asarray(
        jit_element_matrices(
            j_sys.unknown_forms,
            JCompiled(j_sys).lhs_blocks,
            JBatch(JCache(3).get_basis2d(p + dk, p + dk, p + 3, p + 3), corners),
        )
    )
    t_incl = reference_inclusion_matrix(t_sys.unknown_forms, (p, p), (p + dk, p + dk), "cpu")
    j_incl = np.asarray(j_inclusion(j_sys.unknown_forms, (p, p), (p + dk, p + dk)))
    assert _rel(t_incl + 1.0, j_incl + 1.0) <= 1e-12
    assert _rel(t_blocks.numpy(), j_blocks) <= 1e-12
    got = galerkin_product(t_blocks, torch.as_tensor(t_incl)).numpy()
    ref = JGreen._galerkin_finalize(None, j_incl, j_blocks)
    assert _rel(got, ref) <= 1e-12
    # The per-element form of the projector gives the same product.
    per_element = torch.as_tensor(np.broadcast_to(t_incl, (6, *t_incl.shape)).copy())
    assert _rel(galerkin_product(t_blocks, per_element).numpy(), ref) <= 1e-12


def test_reference_inclusion_matches_per_element_projector():
    """The shared inclusion equals the per-element L2 projector on deformed
    quads (exact quadrature), which is what lets a one-order mesh keep one
    [n_f, n_c] matrix; the port's inclusion equals the JAX package's."""
    from mfv2d_torch.evaluation import ElementBatch, element_projector, reference_inclusion_matrix
    from mfv2d_tpu.evaluation import reference_inclusion_matrix as j_inclusion

    rng = np.random.default_rng(3)
    base = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float)
    corners = base[None] + 0.25 * rng.uniform(-1, 1, (6, 4, 2))
    spec = tf.ElementFormSpecification(
        ("q", tf.UnknownFormOrder.FORM_ORDER_1), ("u", tf.UnknownFormOrder.FORM_ORDER_2)
    )
    j_spec = jf.ElementFormSpecification(
        ("q", jf.UnknownFormOrder.FORM_ORDER_1), ("u", jf.UnknownFormOrder.FORM_ORDER_2)
    )
    p, dk = 3, 2
    incl = reference_inclusion_matrix(spec, (p, p), (p + dk, p + dk), "cpu")
    assert np.abs(incl - np.asarray(j_inclusion(j_spec, (p, p), (p + dk, p + dk)))).max() < 1e-12
    io = p + dk + 3
    cache = TCache(0)
    coarse = ElementBatch(cache.get_basis2d(p, p, io, io), corners, "cpu")
    fine = ElementBatch(cache.get_basis2d(p + dk, p + dk, io, io), corners, "cpu")
    off_c = spec.form_offsets(p, p)
    off_f = spec.form_offsets(p + dk, p + dk)
    for i, proj in enumerate(element_projector(spec, coarse, fine)):
        block = incl[off_f[i] : off_f[i + 1], off_c[i] : off_c[i + 1]]
        assert np.abs(proj.numpy() - block).max() < 1e-12


def _nonlinear_lhs(mf):
    """A flow whose advection is an interior product with the unknown flux on
    the left-hand side, so the non-symmetric system has nonlinear blocks."""
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    v, p = u.weight, q.weight
    symmetric = mf.KFormSystem(
        p.derivative @ u - p @ q == 0,
        -1.0 * (v @ q.derivative) == 0,
    )
    advection = mf.KFormSystem(
        p.derivative @ u - p @ q == 0,
        -1.0 * (v @ q.derivative) - (q * v @ q) == 0,
    )
    return symmetric, advection


def test_nonlinear_vms_device_ops_match_host_csr():
    """The device applies of a one-order mesh against host CSR operators
    built from the per-element projectors and advection matrices, before and
    after a nonlinear update of the advection table; and against the JAX
    package's operator on the same vectors."""
    import scipy.sparse as sp

    from mfv2d_torch.evaluation import (
        compute_element_matrices,
        element_projector,
        evaluate_static_fields,
    )

    ops = []
    for mf in (tf, jf):
        symmetric, advection = _nonlinear_lhs(mf)
        mesh = mf.examples.unit_square_mesh(3, 3, 2, _deformation)
        ops.append(_operator(mf, mesh, 2, True, symmetric, advection))
    (op, disc), (j_op, _) = ops
    assert op._dev_ops and op.compiled_advection.nonlin_blocks is not None
    spec = disc.form_spec
    coarse, fine = disc.buckets[0].batch, op.fine_batches[0]
    offsets_c = spec.form_offsets(*coarse.orders)
    offsets_f = spec.form_offsets(*fine.orders)
    per_element = np.zeros((coarse.n_elements, offsets_f[-1], offsets_c[-1]))
    for i, proj in enumerate(element_projector(spec, coarse, fine)):
        per_element[:, offsets_f[i] : offsets_f[i + 1], offsets_c[i] : offsets_c[i + 1]] = proj.numpy()
    projector = sp.block_diag(list(per_element), format="csr")
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, projector.shape[0])
    u = rng.uniform(-1, 1, projector.shape[1])
    assert _rel(op._project_to_coarse(x), x @ projector) <= 1e-12
    assert _rel(op._prolong_to_fine(u), projector @ u) <= 1e-12
    assert _rel(op.projector_c2f.toarray(), projector.toarray()) <= 1e-12

    statics = evaluate_static_fields(fine, op.compiled_advection.fields)

    def host_advection(fine_dofs=None):
        mats = compute_element_matrices(
            spec, op.compiled_advection.linear_blocks, fine, static_fields=statics
        )
        if fine_dofs is not None:
            mats = mats + compute_element_matrices(
                spec,
                op.compiled_advection.nonlin_blocks,
                fine,
                dofs=torch.as_tensor(fine_dofs.reshape(coarse.n_elements, -1)),
                static_fields=statics,
            )
        return sp.block_diag(list(mats.numpy()), format="csr")

    assert _rel(op._apply_fine_advection(x), host_advection() @ x) <= 1e-12
    coarse_dofs = rng.uniform(-1, 1, disc.n_dofs + op.coarse_padding)
    op.update_nonlinear_advection(coarse_dofs)
    j_op.update_nonlinear_advection(coarse_dofs)
    fine_dofs = projector @ coarse_dofs[: disc.n_dofs]
    assert _rel(op._apply_fine_advection(x), host_advection(fine_dofs) @ x) <= 1e-12
    assert _rel(op._apply_fine_advection(x), j_op._apply_fine_advection(x)) <= 1e-12
    assert _rel(op.fine_scale_greens_function(x), j_op.fine_scale_greens_function(x)) <= 1e-10
