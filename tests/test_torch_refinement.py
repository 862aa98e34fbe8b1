"""hp refinement of the port against the JAX package.

Every estimator runs on a 3x3 mesh at p=2-3 with one split and one raised
leaf, in both packages on the same solution vector: ``element_error``,
``href_cost`` and ``dir_cost`` must agree to 1e-10 relative (the VMS
estimator, whose fine-scale iteration stops at a tolerance, to 1e-8).
``refine_mesh_based_on_error`` runs on identical error arrays, so the
refined meshes (leaf indices, orders, corners) must be exactly equal.  Two rounds of ``solve_system_2d``
with refinement on the hp advection-diffusion gallery system must agree to
1e-10 on solutions and on the estimates in the cell data, with equal meshes;
the JAX package's round-1 mesh crosses to the port in the checkpoint format
(``checkpoint.mesh_to_arrays`` / ``mesh_from_arrays``) for round 2.
"""

import importlib

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_torch.checkpoint as tcheckpoint
import mfv2d_torch.refinement as trefinement
import mfv2d_tpu as jf
import mfv2d_tpu.checkpoint as jcheckpoint
import mfv2d_tpu.refinement as jrefinement
from mfv2d_torch.models import flow as tflow
from mfv2d_torch.models import transport as ttransport
from mfv2d_tpu.models import flow as jflow
from mfv2d_tpu.models import transport as jtransport

torch.set_num_threads(1)

NU = -0.05


def a_field(x, y):
    return np.stack(((3 * y - x), (2 - y + 0 * x)), axis=-1)


def u_exact(x, y):
    return 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)


def q_exact(x, y):
    return np.stack(
        (
            -np.pi * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
            -np.pi * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
        ),
        axis=-1,
    )


def source_exact(x, y):
    return np.sum(a_field(x, y) * q_exact(x, y), axis=-1) - NU * np.pi**2 * u_exact(
        x, y
    ) / 2


def bump(x, y):
    return np.exp(-8 * (x**2 + y**2)) + 0.05 * x


def bump_source(x, y):
    r2 = x**2 + y**2
    return (256 * r2 - 32) * np.exp(-8 * r2)


def bump_flux(x, y):
    gx = -16 * x * np.exp(-8 * (x**2 + y**2)) + 0.05
    gy = -16 * y * np.exp(-8 * (x**2 + y**2))
    return np.stack((gy, -gx), axis=-1)


def _tree(mesh):
    """A mesh's split tree, corners and orders (-1 for a split element), as
    its own package's checkpoint writes them."""
    ck = jcheckpoint if type(mesh).__module__.startswith("mfv2d_tpu") else tcheckpoint
    arrays = ck.mesh_to_arrays(mesh)
    return arrays["children"], arrays["corners"], arrays["orders"]


def rel(mine, ref) -> float:
    mine = np.asarray(mine, np.float64)
    ref = np.asarray(ref, np.float64)
    assert mine.shape == ref.shape
    assert np.array_equal(np.isinf(mine), np.isinf(ref))
    finite = np.isfinite(ref)
    if not finite.any():
        return 0.0
    scale = np.abs(ref[finite]).max()
    return float(np.abs(mine[finite] - ref[finite]).max() / scale) if scale else 0.0


def _mesh(mf):
    """3x3 at p=3 with the centre split into (2, 2) children and the first
    leaf raised to (4, 3): buckets (2, 2), (3, 3) and (4, 3)."""
    mesh = mf.examples.unit_square_mesh(3, 3, 3)
    mesh.split_element(4, *([(2, 2)] * 4))
    mesh.set_leaf_orders(0, 4, 3)
    return mesh


def _advdif(mf, transport):
    model = transport.linear_advection_diffusion(NU, a_field, u_exact, source_exact)
    return model.system, [], [], model.u


def _direct_poisson(mf, transport):
    u = mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_0)
    q = mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1)
    system = mf.KFormSystem(
        u.weight.derivative @ u.derivative
        == -(u.weight @ bump_source) + (u.weight ^ bump_flux),
        q.weight @ u.derivative - q.weight @ q == 0,
        sorting=lambda f: f.order,
    )
    return system, [(u, bump)], [], u


def _navier_stokes(mf, flow):
    model = flow.navier_stokes(10.0)
    return (
        model.system,
        [(model.velocity, flow.ns_velocity_exact)],
        [(0.0, model.pressure)],
        model.velocity,
    )


def _setup(mf, mod, make, mesh):
    """The package's discretization, evaluator and settings of a system."""
    pkg = mf.__name__
    compiler = importlib.import_module(f"{pkg}.compiler")
    basis = importlib.import_module(f"{pkg}.ops.basis")
    discretization = importlib.import_module(f"{pkg}.solver.discretization")
    solve = importlib.import_module(f"{pkg}.solver.solve")
    system, strong, constrained, target = make(mf, mod)
    bcs = [mf.BoundaryCondition2DSteady(f, mesh.boundary_indices, g) for f, g in strong]
    kwargs = {"device": "cpu"} if pkg == "mfv2d_torch" else {}
    disc = discretization.discretize_mesh(
        mesh, system.unknown_forms, basis.FemCache(3), **kwargs
    )
    evaluator = solve.SystemEvaluator(disc.form_spec, compiler.CompiledSystem(system), disc)
    return system, bcs, constrained, target, disc, evaluator


def _port_solution(system, bcs, constrained, disc, evaluator) -> np.ndarray:
    from mfv2d_torch.solver.solve import (
        FrozenSaddleSolver,
        compute_linear_system,
        non_linear_solve_run,
    )

    forcing, matrices, lag_mat, lag_vec = compute_linear_system(
        disc, system, evaluator, constrained, bcs, None
    )
    explicit = np.concatenate((forcing, lag_vec))
    solution, _, _, _, _ = non_linear_solve_run(
        20, 1.0, 1e-10, 0.0, False, evaluator, explicit, np.zeros(disc.n_dofs),
        np.zeros(lag_vec.size), float(np.abs(explicit).max()),
        FrozenSaddleSolver(evaluator.matrices_per_leaf(matrices), lag_mat), lag_mat,
    )
    return solution


def _custom_error(x, y, w, u, **_):
    err = np.sum((u - u_exact(x, y)) ** 2 * w)
    return float(err), float(0.5 * err)


# name: (system, estimator arguments).  Estimator arguments are built per
# package from (mf, target form).
ESTIMATORS = {
    "explicit": (_advdif, lambda mf, t: mf.ErrorEstimateExplicit(t, u_exact)),
    "explicit_recon_orders": (
        _advdif, lambda mf, t: mf.ErrorEstimateExplicit(t, u_exact, (6, 5))
    ),
    "order_reduction_ignore": (
        _advdif, lambda mf, t: mf.ErrorEstimateL2OrderReduction(t, 2, "ignore")
    ),
    "order_reduction_prioritize": (
        _advdif, lambda mf, t: mf.ErrorEstimateL2OrderReduction(t, 2, "prioritize")
    ),
    "local_inverse": (_advdif, lambda mf, t: mf.ErrorEstimateLocalInverse(t, 1)),
    "local_inverse_strong": (
        _direct_poisson, lambda mf, t: mf.ErrorEstimateLocalInverse(t, 2, (t,))
    ),
    "local_inverse_strong_constrained": (
        _navier_stokes, lambda mf, t: mf.ErrorEstimateLocalInverse(t, 1, (t,))
    ),
    "custom": (
        _advdif, lambda mf, t: mf.ErrorEstimateCustom((t,), _custom_error, (5, 5))
    ),
    "fine_solve": (_advdif, lambda mf, t: mf.ErrorEstimateFineSolve(t, 1)),
}


@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_estimator_matches_jax(name):
    make, estimator = ESTIMATORS[name]
    mod = {_navier_stokes: (tflow, jflow)}.get(make, (ttransport, jtransport))
    t_system, t_bcs, t_constrained, t_target, t_disc, t_eval = _setup(
        tf, mod[0], make, _mesh(tf)
    )
    j_system, j_bcs, j_constrained, j_target, j_disc, j_eval = _setup(
        jf, mod[1], make, _mesh(jf)
    )
    solution = _port_solution(t_system, t_bcs, t_constrained, t_disc, t_eval)
    results = []
    for pkg, refinement, system, bcs, constrained, target, disc, evaluator in (
        (tf, trefinement, t_system, t_bcs, t_constrained, t_target, t_disc, t_eval),
        (jf, jrefinement, j_system, j_bcs, j_constrained, j_target, j_disc, j_eval),
    ):
        corners_before = [disc.mesh.get_leaf_corners(i) for i in disc.leaf_indices]
        orders_before = disc.element_orders.tolist()
        mesh, err, cost = refinement.perform_mesh_refinement(
            disc, solution, system, evaluator, estimator(pkg, target), 0.5,
            pkg.RefinementLimitElementCount(0.5, 6), False, bcs, 5, None,
            constrained, anisotropic_p=True,
        )
        # The coarse mesh is left as it was (the fine residuals raise its
        # orders and lower them back).
        assert [list(disc.mesh.get_leaf_orders(i)) for i in disc.leaf_indices] == orders_before
        assert all(
            np.array_equal(disc.mesh.get_leaf_corners(i), c)
            for i, c in zip(disc.leaf_indices, corners_before)
        )
        results.append((_tree(mesh), err, cost))
    (t_mesh, t_err, t_cost), (j_mesh, j_err, j_cost) = results
    assert rel(t_err, j_err) <= 1e-10
    assert rel(t_cost, j_cost) <= 1e-10
    for mine, ref in zip(t_mesh, j_mesh):
        assert np.array_equal(mine, ref)
    if "order_reduction" in name:
        low = t_disc.element_orders[:, 0] <= 2
        assert low.any() and (~low).any()
        assert np.all(t_err[low] == (0.0 if "ignore" in name else np.inf))


@pytest.mark.parametrize("name", ["explicit", "order_reduction_prioritize", "local_inverse"])
def test_estimator_dir_costs_match_jax(name):
    """The directional costs that anisotropic p refinement reads."""
    make, estimator = ESTIMATORS[name]
    t_system, t_bcs, _, t_target, t_disc, t_eval = _setup(tf, ttransport, make, _mesh(tf))
    j_system, j_bcs, _, j_target, j_disc, j_eval = _setup(jf, jtransport, make, _mesh(jf))
    solution = _port_solution(t_system, t_bcs, [], t_disc, t_eval)
    fns = {
        "explicit": lambda r, d, t, s, e, b: r.error_estimate_with_explicit_solution(
            d, solution, t, u_exact, None, None
        ),
        "order_reduction_prioritize": lambda r, d, t, s, e, b: (
            r.error_estimate_with_order_reduction(d, solution, t, 2, "prioritize")
        ),
        "local_inverse": lambda r, d, t, s, e, b: r.error_estimate_with_local_inversion(
            d, solution, s, e.compiled, b, 1, t, (), ()
        ),
    }
    mine = fns[name](trefinement, t_disc, t_target, t_system, t_eval, t_bcs)
    ref = fns[name](jrefinement, j_disc, j_target, j_system, j_eval, j_bcs)
    for m, r in zip(mine, ref):
        assert rel(m, r) <= 1e-10


@pytest.mark.parametrize("orders", [(3, 3), (4, 2)])
@pytest.mark.parametrize("vector", [False, True])
def test_legendre_measures_match_jax(orders, vector):
    """The per-element Legendre helpers against the JAX package's, and the
    batched measures against the per-element ones."""
    p1, p2 = orders
    rng = np.random.default_rng(p1 + 3 * p2 + vector)
    nodes_xi = np.sort(rng.uniform(-1, 1, p1 + 3))
    nodes_eta = np.sort(rng.uniform(-1, 1, p2 + 2))
    w2d = rng.uniform(0.1, 1.0, (nodes_eta.size, nodes_xi.size))
    shape = (3, nodes_eta.size, nodes_xi.size) + ((2,) if vector else ())
    det = rng.uniform(0.5, 2.0, shape[:3])
    u, err = rng.normal(size=shape), 0.1 * rng.normal(size=shape)
    args = (p1, p2, nodes_xi, nodes_eta, w2d)
    batched = trefinement._batched_legendre_measures(*args, det, u, err)
    ref = jrefinement._batched_legendre_measures(*args, det, u, err)
    for mine, r in zip(batched, ref):
        assert rel(mine, r) <= 1e-12
    for e in range(3):
        one = (*args, det[e])
        l2, h = tf.compute_legendre_error_estimates(*one, u[e], err[e])
        assert (l2, h) == jf.compute_legendre_error_estimates(*one, u[e], err[e])
        assert rel([l2, h], [batched[0][e], batched[1][e]]) <= 1e-12
        costs = trefinement.compute_legendre_directional_costs(*one, err[e])
        assert costs == jrefinement.compute_legendre_directional_costs(*one, err[e])
        assert rel(costs, batched[2][e]) <= 1e-12
        sampled = u[e][..., 0] if vector else u[e]
        assert np.array_equal(
            tf.compute_legendre_coefficients(p1, p2, nodes_xi, nodes_eta, sampled, det[e]),
            jf.compute_legendre_coefficients(p1, p2, nodes_xi, nodes_eta, sampled, det[e]),
        )


def _mesh_to_refine(mf):
    mesh = mf.examples.unit_square_mesh(4, 4, 3)
    mesh.split_element(5, (2, 2), (2, 3), (3, 2), (1, 1))
    mesh.set_leaf_orders(0, 5, 4)
    mesh.set_leaf_orders(10, 2, 2)
    return mesh


LIMITS = {
    "element_count": lambda mf: mf.RefinementLimitElementCount(0.4, 6),
    "unknown_count": lambda mf: mf.RefinementLimitUnknownCount(0.3, 250),
    "error_value": lambda mf: mf.RefinementLimitErrorValue(0.05, 0.0),
}


@pytest.mark.parametrize("order_limits", [(None, None), (4, 2)])
@pytest.mark.parametrize("ratio", [0.0, np.inf])
@pytest.mark.parametrize("anisotropic", [False, True])
@pytest.mark.parametrize("limit", list(LIMITS))
def test_refine_mesh_matches_jax(limit, anisotropic, ratio, order_limits):
    """refine_mesh_based_on_error on identical error arrays: the same
    leaves, orders and corners, exactly."""
    results = []
    for mf, refinement in ((tf, trefinement), (jf, jrefinement)):
        mesh = _mesh_to_refine(mf)
        leaves = mesh.get_leaf_indices()
        rng = np.random.default_rng(len(leaves))
        error = rng.uniform(0.01, 1.0, leaves.size)
        cost = error * rng.uniform(0.0, 2.0, leaves.size)
        dir_cost = rng.uniform(0.0, 1.0, (leaves.size, 2))
        dir_cost[::3, 0] = 0.0
        spec = mf.ElementFormSpecification(
            mf.KFormUnknown("q", mf.UnknownFormOrder.FORM_ORDER_1),
            mf.KFormUnknown("u", mf.UnknownFormOrder.FORM_ORDER_2),
        )
        refined = refinement.refine_mesh_based_on_error(
            mesh, 700, ratio, LIMITS[limit](mf), spec, leaves, error, cost,
            order_limits[0], order_limits[1],
            dir_cost=dir_cost if anisotropic else None,
        )
        assert mesh.leaf_count == leaves.size  # the input mesh is not changed
        results.append((refined.get_leaf_indices(), *_tree(refined)))
    for mine, ref in zip(*results):
        assert np.array_equal(mine, ref)
    assert not np.array_equal(results[0][3], _tree(_mesh_to_refine(tf))[2])


def test_refine_mesh_rejects_unknown_limit():
    mesh = _mesh_to_refine(tf)
    n = mesh.leaf_count
    with pytest.raises(TypeError, match="refinement limit"):
        trefinement.refine_mesh_based_on_error(
            mesh, 10, 0.0, object(), None, mesh.get_leaf_indices(),
            np.ones(n), np.ones(n), None, None,
        )


def _advdif_solve(mf, transport, mesh, estimator, **kwargs):
    model = transport.linear_advection_diffusion(NU, a_field, u_exact, source_exact)
    settings = mf.RefinementSettings(
        estimator(mf, model.u),
        mf.RefinementLimitElementCount(0.3, 4),
        h_refinement_ratio=0.3,
        upper_order_limit=4,
    )
    return mf.solve_system_2d(
        mesh,
        mf.SystemSettings(model.system),
        mf.SolverSettings(mf.ConvergenceSettings(100, 1e-10, 0)),
        refinement_settings=settings,
        recon_order=5,
        **kwargs,
    )


@pytest.mark.parametrize(
    "estimator",
    [
        lambda mf, u: mf.ErrorEstimateLocalInverse(u, 1),
        lambda mf, u: mf.ErrorEstimateL2OrderReduction(u, 1),
    ],
    ids=["local_inverse", "order_reduction"],
)
def test_refinement_rounds_match_jax(estimator):
    """Two rounds on the hp advection-diffusion system from 3x3 p=2; round 2
    starts in both packages from the JAX package's round-1 mesh."""
    t_mesh = tf.examples.unit_square_mesh(3, 3, 2)
    j_mesh = jf.examples.unit_square_mesh(3, 3, 2)
    for _ in range(2):
        tgrids, tstats, t_out = _advdif_solve(tf, ttransport, t_mesh, estimator, device="cpu")
        jgrids, jstats, j_out = _advdif_solve(jf, jtransport, j_mesh, estimator)
        assert tstats.element_orders == jstats.element_orders
        assert tstats.n_total_dofs == jstats.n_total_dofs
        for name in ("u", "q"):
            assert rel(tgrids[-1].point_data[name], jgrids[-1].point_data[name]) <= 1e-10
        for name in ("error_estimate", "h_ref_cost_estimate"):
            assert rel(tgrids[-1].cell_data[name], jgrids[-1].cell_data[name]) <= 1e-10
        for mine, ref in zip(_tree(t_out), _tree(j_out)):
            assert np.array_equal(mine, ref)
        before, after = _tree(j_mesh), _tree(j_out)
        # Each round splits elements or raises their orders.
        assert after[0].shape[0] > before[0].shape[0] or (
            after[2] > before[2]
        ).any()
        j_mesh = j_out
        t_mesh = tcheckpoint.mesh_from_arrays(jcheckpoint.mesh_to_arrays(j_out))


def test_mesh_from_arrays_carries_a_refined_mesh():
    """A JAX package's refined mesh crosses to the port in the checkpoint
    format, its topology and boundary with it."""
    j_mesh = jf.examples.unit_square_mesh(3, 3, 2)
    j_mesh.split_element(4, (3, 3), (2, 2), (1, 1), (2, 3))
    j_mesh.split_element(j_mesh.get_element_children(4)[2], *([(4, 4)] * 4))
    j_mesh.set_leaf_orders(0, 5, 2)
    arrays = jcheckpoint.mesh_to_arrays(j_mesh)
    t_mesh = tcheckpoint.mesh_from_arrays(arrays)
    assert np.array_equal(t_mesh.get_leaf_indices(), j_mesh.get_leaf_indices())
    for i in range(j_mesh.element_count):
        assert t_mesh.get_element_parent(i) == j_mesh.get_element_parent(i)
        assert t_mesh.get_element_children(i) == j_mesh.get_element_children(i)
        assert t_mesh.get_element_depth(i) == j_mesh.get_element_depth(i)
    for i in j_mesh.get_leaf_indices():
        assert t_mesh.get_leaf_orders(i) == j_mesh.get_leaf_orders(i)
        assert np.array_equal(t_mesh.get_leaf_corners(i), j_mesh.get_leaf_corners(i))
    assert np.array_equal(t_mesh.boundary_indices, j_mesh.boundary_indices)
    back = tcheckpoint.mesh_to_arrays(t_mesh)
    assert sorted(back) == sorted(arrays)
    for key, ref in arrays.items():
        assert np.array_equal(back[key], ref), key
    assert (arrays["orders"][4] == -1).all()  # a split element


def _u_skew(x, y):
    return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y) * np.exp(0.4 * x + 0.2 * y)


def _source_skew(x, y):
    return np.exp(0.5 * x + 0.25 * y)


def _skew_flow(mf, transport):
    """The nonlinear flow of bench_vms.py with an asymmetric boundary value
    and source, so that no two VMS estimates tie at a refinement cut."""
    model = transport.nonlinear_flow(-1.0, _u_skew, _source_skew)
    return model.system, [], [], model.u


def _vms_estimator(mf, system, max_iters=20):
    """``ErrorEstimateVMS`` of u with the flow's diffusion as the symmetric
    system and the flow itself as the non-symmetric one."""
    forms = {f.label: f for f in system.unknown_forms.iter_forms()}
    u, q = forms["u"], forms["q"]
    symmetric = mf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == q.weight ^ _u_skew,
        -1.0 * (u.weight @ q.derivative) == -(u.weight @ _source_skew),
    )
    return mf.ErrorEstimateVMS(u, symmetric, system, 1, max_iters, 1e-12, 1e-10)


def test_vms_estimator_raises_naming_roadmap_item():
    """The VMS estimator (ROADMAP module item 9; the name is from when it
    raised naming that item) against the JAX package: on the hp mesh of
    buckets (2, 2), (3, 3) and (4, 3) from the same solution vector, and
    through one round of ``solve_system_2d`` on 4x4 at p=2; estimates and
    costs to 1e-8, refined meshes equal.  A target form outside the system
    raises in both packages."""
    t_system, _, _, t_target, t_disc, t_eval = _setup(tf, ttransport, _skew_flow, _mesh(tf))
    j_system, _, _, j_target, j_disc, j_eval = _setup(jf, jtransport, _skew_flow, _mesh(jf))
    solution = _port_solution(t_system, [], [], t_disc, t_eval)
    results = []
    for pkg, refinement, system, disc, evaluator in (
        (tf, trefinement, t_system, t_disc, t_eval),
        (jf, jrefinement, j_system, j_disc, j_eval),
    ):
        orders_before = disc.element_orders.tolist()
        mesh, err, cost = refinement.perform_mesh_refinement(
            disc, solution, system, evaluator, _vms_estimator(pkg, system), 0.5,
            pkg.RefinementLimitElementCount(0.5, 6), False, [], 5, None, [],
        )
        assert [list(disc.mesh.get_leaf_orders(i)) for i in disc.leaf_indices] == orders_before
        results.append((_tree(mesh), err, cost))
    (t_mesh, t_err, t_cost), (j_mesh, j_err, j_cost) = results
    assert np.all(t_err > 0)
    assert rel(t_err, j_err) <= 1e-8
    assert rel(t_cost, j_cost) <= 1e-8
    for mine, ref in zip(t_mesh, j_mesh):
        assert np.array_equal(mine, ref)

    rounds = []
    for pkg, mod, on_cpu in ((tf, ttransport, {"device": "cpu"}), (jf, jtransport, {})):
        system = _skew_flow(pkg, mod)[0]
        settings = pkg.RefinementSettings(
            _vms_estimator(pkg, system), pkg.RefinementLimitElementCount(0.1, 128)
        )
        rounds.append(
            pkg.solve_system_2d(
                pkg.examples.unit_square_mesh(4, 4, 2),
                pkg.SystemSettings(system, over_integration_order=3),
                pkg.SolverSettings(pkg.ConvergenceSettings(40, 1e-9, 0)),
                refinement_settings=settings,
                recon_order=4,
                **on_cpu,
            )
        )
    (t_grids, t_stats, t_out), (j_grids, j_stats, j_out) = rounds
    assert np.array_equal(t_stats.iter_history, j_stats.iter_history)
    for name in ("error_estimate", "h_ref_cost_estimate"):
        assert rel(t_grids[-1].cell_data[name], j_grids[-1].cell_data[name]) <= 1e-8
    for mine, ref in zip(_tree(t_out), _tree(j_out)):
        assert np.array_equal(mine, ref)
    assert (_tree(t_out)[2] > 2).any()

    stray = tf.KFormUnknown("w", tf.UnknownFormOrder.FORM_ORDER_2)
    bad = tf.ErrorEstimateVMS(stray, t_system, t_system, 1, 5, 1e-8, 1e-8)
    with pytest.raises(ValueError, match="not in the system"):
        trefinement.perform_mesh_refinement(
            t_disc, solution, t_system, t_eval, bad, 0.0,
            tf.RefinementLimitElementCount(0.1, 2), False, [], None, None, [],
        )
