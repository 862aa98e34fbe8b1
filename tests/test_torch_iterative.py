"""The element-local trace solvers of the port against the JAX package.

Both packages get literally the same element matrices and constraint CSR
(assembled once by the JAX package; the two assemblies agree to 1e-12, see
test_torch_evaluation.py), each on its own discretization of the same mesh.
The port builds its element inverses with ``gj_inverse`` (its plain version
on the CPU) where the JAX package on the CPU factors with LU, so the two
differ by round-off of order cond(A_e) * eps.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sla
import torch

import mfv2d_torch as tf
import mfv2d_tpu as jf
from mfv2d_torch.ops.basis import FemCache as TFemCache
from mfv2d_torch.solver import iterative as ti
from mfv2d_torch.solver.discretization import discretize_mesh as t_discretize
from mfv2d_torch.solver.solve import ConvergenceSettings as TConv
from mfv2d_torch.tracing import tracer
from mfv2d_tpu.compiler import CompiledSystem
from mfv2d_tpu.models import flow as jflow
from mfv2d_tpu.models import poisson as jpoisson
from mfv2d_tpu.ops.basis import FemCache
from mfv2d_tpu.solver import iterative as ji
from mfv2d_tpu.solver.discretization import discretize_mesh
from mfv2d_tpu.solver.solve import ConvergenceSettings as JConv
from mfv2d_tpu.solver.solve import SystemEvaluator, compute_linear_system
from mfv2d_torch.models import flow as tflow
from mfv2d_torch.models import poisson as tpoisson

torch.set_num_threads(1)

jsolve_mod = importlib.import_module("mfv2d_tpu.solve_system_2d")
tsolve_mod = importlib.import_module("mfv2d_torch.solve_system_2d")


def rel(mine, ref) -> float:
    mine = mine.cpu().numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    ref = np.asarray(ref)
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


def _setup(n=3, p=3):
    """The systems of tests/test_iterative.py ``_setup``, for both packages."""
    system = jpoisson.mixed_poisson().system
    mesh = jf.examples.unit_square_mesh(n, n, p)
    disc = discretize_mesh(mesh, system.unknown_forms, FemCache(3))
    evaluator = SystemEvaluator(system.unknown_forms, CompiledSystem(system), disc)
    forcing, matrices, lagrange_mat, lagrange_vec = compute_linear_system(
        disc, system, evaluator, [], [], None
    )
    matrices = [np.array(m) for m in matrices]
    tsystem = tpoisson.mixed_poisson().system
    tdisc = t_discretize(
        tf.examples.unit_square_mesh(n, n, p), tsystem.unknown_forms, TFemCache(3), device="cpu"
    )
    return disc, tdisc, forcing, matrices, lagrange_mat, lagrange_vec


@pytest.fixture(scope="module")
def setup33():
    return _setup()


@pytest.fixture(scope="module")
def systems33(setup33):
    disc, tdisc, _, matrices, g, _ = setup33
    return (
        ji.BlockSaddleSystem(disc, matrices, g),
        ti.BlockSaddleSystem(tdisc, matrices, g),
    )


def test_block_operators_match_jax(setup33, systems33):
    disc, _, _, _, g, _ = setup33
    jsys, tsys = systems33
    rng = np.random.default_rng(3)
    x = rng.normal(size=disc.n_dofs)
    lam = rng.normal(size=g.shape[0])
    tx, tlam = torch.tensor(x), torch.tensor(lam)
    pairs = {
        "apply_diagonal": (jsys.apply_diagonal(jnp.asarray(x)), tsys.apply_diagonal(tx)),
        "apply_trace": (jsys.apply_trace(jnp.asarray(x)), tsys.apply_trace(tx)),
        "apply_trace_transpose": (
            jsys.apply_trace_transpose(jnp.asarray(lam)),
            tsys.apply_trace_transpose(tlam),
        ),
        "apply_saddle_u": (
            jsys.apply_saddle(jnp.asarray(x), jnp.asarray(lam))[0],
            tsys.apply_saddle(tx, tlam)[0],
        ),
        "apply_saddle_lam": (
            jsys.apply_saddle(jnp.asarray(x), jnp.asarray(lam))[1],
            tsys.apply_saddle(tx, tlam)[1],
        ),
        "schur_jacobi_diagonal": (
            jsys.schur_jacobi_diagonal(),
            tsys.schur_jacobi_diagonal(),
        ),
    }
    for name, (ref, mine) in pairs.items():
        assert mine.dtype == torch.float64, name
        assert rel(mine, ref) <= 1e-12, (name, rel(mine, ref))
    # The explicit-inverse applies: round-off of the inverse, not of a GEMV.
    inv_pairs = {
        "apply_diagonal_inverse": (
            jsys.apply_diagonal_inverse(jnp.asarray(x)),
            tsys.apply_diagonal_inverse(tx),
        ),
        "apply_schur": (jsys.apply_schur(jnp.asarray(lam)), tsys.apply_schur(tlam)),
    }
    for name, (ref, mine) in inv_pairs.items():
        assert rel(mine, ref) <= 1e-10, (name, rel(mine, ref))


def test_inverse_build_is_the_explicit_branch(systems33):
    _, tsys = systems33
    assert all(r == 0 for r in tsys._refine_rounds)
    for inv, b in zip(tsys.inverses, tsys.blocks):
        eye = torch.eye(b.shape[-1], dtype=torch.float64).expand_as(b)
        assert float((inv @ b - eye).abs().max()) <= 1e-10


def test_assemble_schur_sparse_matches_jax(systems33):
    jsys, tsys = systems33
    ref = jsys.assemble_schur_sparse().toarray()
    mine = tsys.assemble_schur_sparse().toarray()
    assert rel(mine, ref) <= 1e-12
    assert np.abs(mine - mine.T).max() <= 1e-12 * np.abs(mine).max()


@pytest.mark.parametrize("preconditioner", [None, "jacobi"])
def test_solve_schur_iterative_matches_jax(setup33, systems33, preconditioner):
    _, _, forcing, _, _, lagrange_vec = setup33
    jsys, tsys = systems33
    ju, jlam, _, jit = ji.solve_schur_iterative(
        jsys, jnp.asarray(forcing), jnp.asarray(lagrange_vec),
        JConv(2000, 1e-12, 0.0), preconditioner=preconditioner,
    )
    tu, tlam, _, tit = ti.solve_schur_iterative(
        tsys, forcing, lagrange_vec, TConv(2000, 1e-12, 0.0),
        preconditioner=preconditioner,
    )
    assert rel(tu, ju) <= 1e-8
    assert rel(tlam, jlam) <= 1e-8
    assert abs(tit - jit) <= 2, (tit, jit)


def test_solve_schur_direct_matches_jax(setup33, systems33):
    _, _, forcing, _, _, lagrange_vec = setup33
    jsys, tsys = systems33
    ju, jlam, _, jit = ji.solve_schur_direct(
        jsys, jnp.asarray(forcing), jnp.asarray(lagrange_vec)
    )
    tu, tlam, _, tit = ti.solve_schur_direct(tsys, forcing, lagrange_vec)
    assert tit == jit == 1
    assert rel(tu, ju) <= 1e-10
    assert rel(tlam, jlam) <= 1e-10


@pytest.mark.parametrize("method", ["schur", "gmres", "pcg"])
def test_iterative_solver_interface_matches_jax(method):
    disc, tdisc, forcing, matrices, g, lagrange_vec = _setup(2, 2)
    rhs = np.concatenate([forcing, lagrange_vec])
    ref = ji.IterativeSaddleSolver(
        disc, matrices, g, JConv(5000, 1e-11, 0.0), method=method
    ).solve(rhs)
    mine = ti.IterativeSaddleSolver(
        tdisc, matrices, g, TConv(5000, 1e-11, 0.0), method=method
    ).solve(rhs)
    assert isinstance(mine, np.ndarray) and mine.shape == ref.shape
    assert rel(mine, ref) <= 1e-8


def test_full_system_cg_and_dense_match_jax():
    disc, tdisc, forcing, matrices, g, lagrange_vec = _setup(2, 2)
    rhs = np.concatenate([forcing, lagrange_vec])
    jsys = ji.make_block_saddle_system(disc, matrices, g)
    tsys = ti.make_block_saddle_system(tdisc, matrices, g)
    conv = (400, 1e-11, 0.0)
    ju, jlam, _, _ = ji.solve_cg_iterative(
        jsys, jnp.asarray(forcing), jnp.asarray(lagrange_vec), JConv(*conv)
    )
    tu, tlam, _, _ = ti.solve_cg_iterative(tsys, forcing, lagrange_vec, TConv(*conv))
    assert rel(tu, ju) <= 1e-8
    ref = ji.DenseSaddleSolver(disc, matrices, g).solve(rhs)
    mine = ti.DenseSaddleSolver(tdisc, matrices, g).solve(rhs)
    assert rel(mine, ref) <= 1e-10
    jmat, jn = ji.assemble_dense_saddle(disc, matrices, g)
    tmat, tn = ti.assemble_dense_saddle(tdisc, matrices, g)
    assert tn == jn and np.array_equal(tmat, jmat)


@pytest.mark.parametrize("constrained", [True, False], ids=["with_multipliers", "without"])
def test_sparse_saddle_matrix_is_the_dense_one(setup33, constrained):
    """The one sparse build of [[A, G^T], [G, 0]] (the frozen LU's and the
    VMS saddles') holds the dense assembly's entries, in CSC."""
    from mfv2d_torch.solver.discretization import per_leaf
    from mfv2d_torch.solver.solve import saddle_matrix

    _, tdisc, _, matrices, g, _ = setup33
    g = g if constrained else None
    sparse = saddle_matrix(per_leaf(tdisc, matrices), g)
    dense, n_lag = ti.assemble_dense_saddle(tdisc, matrices, g)
    assert sparse.format == "csc" and sparse.shape == dense.shape
    assert n_lag == (g.shape[0] if constrained else 0)
    assert np.array_equal(sparse.toarray(), dense)


def _reference_saddle(blocks, g) -> sp.csc_matrix:
    """[[A, G^T], [G, 0]] as ``sp.block_diag`` and ``sp.block_array`` build it."""
    mat = sp.block_diag(blocks, format="csr")
    if g is not None:
        mat = sp.block_array(((mat, g.T), (g, None)), format="csr")
    mat = sp.csc_matrix(mat)
    mat.sort_indices()
    return mat


def _port_saddle(mesh, system, bcs=(), constrained=()):
    """The port's element matrices in leaf order and its constraint CSR."""
    from mfv2d_torch.compiler import CompiledSystem as TCompiledSystem
    from mfv2d_torch.solver.solve import SystemEvaluator as TSystemEvaluator
    from mfv2d_torch.solver.solve import compute_linear_system as t_linear_system

    disc = t_discretize(mesh, system.unknown_forms, TFemCache(3), device="cpu")
    evaluator = TSystemEvaluator(system.unknown_forms, TCompiledSystem(system), disc)
    _, matrices, g, _ = t_linear_system(disc, system, evaluator, list(constrained), list(bcs), None)
    return evaluator.matrices_per_leaf(matrices), g


def _saddle_poisson():
    return _port_saddle(tf.examples.unit_square_mesh(3, 3, 3), tpoisson.mixed_poisson().system)


def _saddle_poisson_without_multipliers():
    blocks, _ = _saddle_poisson()
    return blocks, None


def _saddle_navier_stokes():
    model = tflow.navier_stokes(10.0)
    mesh = tf.examples.unit_square_mesh(3, 3, 3)
    bc = tf.BoundaryCondition2DSteady(model.velocity, mesh.boundary_indices, tflow.ns_velocity_exact)
    return _port_saddle(mesh, model.system, [bc], [(0.0, model.pressure)])


def _saddle_hp():
    """Leaves of five orders, whose block sizes interleave in leaf order, with
    hanging-node continuity in G."""
    mesh = tf.examples.unit_square_mesh(4, 4, 3)
    mesh.split_element(5, (2, 2), (2, 3), (3, 2), (1, 1))
    mesh.set_leaf_orders(0, 5, 4)
    mesh.set_leaf_orders(10, 2, 2)
    return _port_saddle(mesh, tpoisson.mixed_poisson().system)


def _saddle_planted_zeros():
    """Blocks with exact zeros planted (a whole block, rows, columns and
    scattered entries) and explicit zeros stored in G."""
    blocks, g = _saddle_poisson()
    rng = np.random.default_rng(7)
    blocks = [b.copy() for b in blocks]
    blocks[0][:] = 0.0
    blocks[1][2, :] = 0.0
    blocks[2][:, 3] = 0.0
    for b in blocks[3:]:
        b[rng.random(b.shape) < 0.1] = 0.0
    g = g.copy()
    g.data[::5] = 0.0
    return blocks, g


SADDLES = {
    "poisson": _saddle_poisson,
    "poisson_without_multipliers": _saddle_poisson_without_multipliers,
    "navier_stokes": _saddle_navier_stokes,
    "hp_mixed_orders": _saddle_hp,
    "planted_zeros": _saddle_planted_zeros,
}


@pytest.mark.parametrize("case", SADDLES)
def test_saddle_matrix_is_the_block_build_bitwise(case):
    """The CSC saddle build holds the arrays of the block_diag/block_array
    build to the bit, in canonical form, every entry of the dense blocks
    and every stored entry of G kept."""
    from mfv2d_torch.solver.solve import saddle_matrix

    blocks, g = SADDLES[case]()
    sizes = [b.shape[0] for b in blocks]
    # The hp mesh's sizes 33 and 16 come back after other sizes in leaf order.
    assert len(set(sizes)) == (5 if case == "hp_mixed_orders" else 1)
    mine = saddle_matrix(blocks, g)
    ref = _reference_saddle(blocks, g)
    assert mine.format == "csc" and mine.shape == ref.shape
    assert mine.has_canonical_format
    for name in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(mine, name), getattr(ref, name)), name
    n_g = 0 if g is None else g.nnz
    assert mine.nnz == sum(b.size for b in blocks) + 2 * n_g


def test_unknown_iterative_method_raises():
    """As in the JAX package, full-system CG is not a selectable method."""
    _, tdisc, _, matrices, g, _ = _setup(2, 2)
    with pytest.raises(ValueError, match="Unknown iterative method"):
        ti.IterativeSaddleSolver(tdisc, matrices, g, TConv(), method="cg")


def _krylov_matrices():
    """The matrices of tests/test_iterative.py test_generic_krylov_small_system."""
    rng = np.random.default_rng(0)
    n = 40
    m = rng.normal(size=(n, n))
    spd = m @ m.T + n * np.eye(n)
    b = rng.normal(size=n)
    ns = m + n * np.eye(n)
    return spd, ns, b


@pytest.mark.parametrize(
    "method", ["cg", "pcg_identity", "pcg_jacobi", "gmres", "gmres_restarted"]
)
def test_generic_krylov_matches_jax(method):
    spd, ns, b = _krylov_matrices()
    n = b.size
    conv = (200, 1e-12, 0.0)
    jb, tb = jnp.asarray(b), torch.tensor(b)
    mat = ns if method.startswith("gmres") else spd
    jmat, tmat = jnp.asarray(mat), torch.tensor(mat)
    d = np.diag(mat)

    def run(mod, conv_cls, a, v, zeros, inv_d):
        if method == "cg":
            return mod.cg_general(lambda x: a @ x, v, zeros, conv_cls(*conv))
        if method.startswith("pcg"):
            scale = inv_d if method == "pcg_jacobi" else 1.0
            return mod.pcg_general(
                lambda x: a @ x, lambda r: scale * r, v, zeros, conv_cls(*conv)
            )
        restart = 10 if method == "gmres_restarted" else None
        return mod.gmres_general(
            lambda x: a @ x, v, zeros, conv_cls(*conv), restart=restart
        )

    jx, jres, jit = run(ji, JConv, jmat, jb, jnp.zeros(n), jnp.asarray(1.0 / d))
    tx, tres, tit = run(ti, TConv, tmat, tb, torch.zeros(n, dtype=torch.float64),
                        torch.tensor(1.0 / d))
    assert rel(tx, jx) <= 1e-10
    assert tit == jit
    assert abs(tres - jres) <= 1e-10 * np.linalg.norm(b)
    assert rel(tx, np.linalg.solve(mat, b)) <= 1e-10


def _solve_capturing(mf, module, monkeypatch, mesh, settings, solver):
    captured = []
    original = module.reconstruct_mesh_from_solution

    def capture(disc, recon_order, solution, *args):
        captured.append(np.array(solution))
        return original(disc, recon_order, solution, *args)

    monkeypatch.setattr(module, "reconstruct_mesh_from_solution", capture)
    on_cpu = {"device": "cpu"} if mf is tf else {}
    _, stats, _ = mf.solve_system_2d(mesh, settings, solver, recon_order=4, **on_cpu)
    monkeypatch.undo()
    return captured[-1], stats


def _mixed_poisson_3x3(mf, poisson, linear_solver):
    model = poisson.mixed_poisson()
    return (
        mf.examples.unit_square_mesh(3, 3, 3),
        mf.SystemSettings(model.system),
        mf.SolverSettings(
            mf.ConvergenceSettings(20, 1e-12, 0.0), linear_solver=linear_solver
        ),
    )


@pytest.mark.parametrize(
    "linear_solver, tol", [("schur_direct", 1e-10), ("dense", 1e-10), ("schur", 1e-8)]
)
def test_solve_system_2d_trace_solvers_match_jax(linear_solver, tol, monkeypatch):
    jsol, jstats = _solve_capturing(
        jf, jsolve_mod, monkeypatch, *_mixed_poisson_3x3(jf, jpoisson, linear_solver)
    )
    tsol, tstats = _solve_capturing(
        tf, tsolve_mod, monkeypatch, *_mixed_poisson_3x3(tf, tpoisson, linear_solver)
    )
    assert rel(tsol, jsol) <= tol
    assert np.array_equal(tstats.iter_history, jstats.iter_history)


def _navier_stokes_4x4(mf, flow):
    model = flow.navier_stokes(10.0)
    mesh = mf.examples.unit_square_mesh(4, 4, 5)
    bc = mf.BoundaryCondition2DSteady(
        model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
    )
    return (
        mesh,
        mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
        mf.SolverSettings(
            mf.ConvergenceSettings(80, 1e-8, 0.0),
            relaxation=0.7,
            linear_solver="schur_direct",
        ),
    )


def test_navier_stokes_schur_direct_matches_jax(monkeypatch):
    jsol, jstats = _solve_capturing(
        jf, jsolve_mod, monkeypatch, *_navier_stokes_4x4(jf, jflow)
    )
    tsol, tstats = _solve_capturing(
        tf, tsolve_mod, monkeypatch, *_navier_stokes_4x4(tf, tflow)
    )
    assert int(jstats.iter_history[-1]) == int(tstats.iter_history[-1]) == 18
    assert rel(tsol, jsol) <= 1e-10


def _port_trace_system(system, n: int, p: int) -> ti.BlockSaddleSystem:
    """The port's BlockSaddleSystem of a linear ``system`` on an n x n mesh
    at order p, on the CPU, with no boundary condition or constraint."""
    from mfv2d_torch.compiler import CompiledSystem as TCompiled
    from mfv2d_torch.solver.solve import (
        SystemEvaluator as TEvaluator,
        compute_linear_system as t_linear_system,
    )

    disc = t_discretize(
        tf.examples.unit_square_mesh(n, n, p), system.unknown_forms, TFemCache(2), device="cpu"
    )
    evaluator = TEvaluator(disc.form_spec, TCompiled(system), disc)
    _, matrices, g, _ = t_linear_system(disc, system, evaluator, [], [], None)
    return ti.BlockSaddleSystem(disc, matrices, g)


def _fill(matrix, permc_spec: str) -> tuple:
    lu = sla.splu(matrix, permc_spec=permc_spec)
    return lu, lu.L.nnz + lu.U.nnz


def _ordering_of_mixed_poisson_16x16_p8(monkeypatch):
    # S is negative definite: the minimum degree ordering, with less fill
    # (0.58x COLAMD's) and the same solution.
    system = _port_trace_system(tpoisson.mixed_poisson().system, 16, 8)
    schur = sp.csc_matrix(system.assemble_schur_sparse())
    assert ti.trace_column_ordering(schur) == "MMD_AT_PLUS_A"
    min_degree, min_degree_fill = _fill(schur, "MMD_AT_PLUS_A")
    colamd, colamd_fill = _fill(schur, "COLAMD")
    assert min_degree_fill <= 0.7 * colamd_fill, (min_degree_fill, colamd_fill)
    b = np.random.default_rng(5).normal(size=schur.shape[0])
    assert rel(min_degree.solve(b), colamd.solve(b)) <= 1e-12
    # The system's own factorization is the one with that ordering.
    assert np.array_equal(system.schur_decomposition().perm_c, min_degree.perm_c)


def _ordering_of_a_zero_diagonal_saddle(monkeypatch):
    # [[A, B^T], [B, 0]]: a structural zero on the diagonal keeps COLAMD.
    rng = np.random.default_rng(6)
    m = rng.normal(size=(8, 8))
    b = rng.normal(size=(3, 8))
    saddle = sp.csc_matrix(
        sp.block_array([[sp.csr_array(m @ m.T + 8 * np.eye(8)), sp.csr_array(b.T)],
                        [sp.csr_array(b), None]])
    )
    assert saddle.diagonal()[8:].tolist() == [0.0] * 3
    assert ti.trace_column_ordering(saddle) == "COLAMD"


def _ordering_of_stokes_4x4_p8(monkeypatch):
    # Config 3's Stokes trace: symmetric in value and pattern, no zero on
    # the diagonal, but indefinite (diagonal of both signs): partial
    # pivoting leaves the diagonal and the minimum degree ordering fills
    # more than COLAMD, which it keeps.
    system = _port_trace_system(tflow.stokes_flow(with_divergence=False).system, 4, 8)
    schur = sp.csc_matrix(system.assemble_schur_sparse())
    diagonal = schur.diagonal()
    assert np.all(diagonal != 0) and diagonal.min() < 0 < diagonal.max()
    assert ti.trace_column_ordering(schur) == "COLAMD"
    _, min_degree_fill = _fill(schur, "MMD_AT_PLUS_A")
    colamd, colamd_fill = _fill(schur, "COLAMD")
    assert colamd_fill < min_degree_fill, (colamd_fill, min_degree_fill)
    assert np.array_equal(system.schur_decomposition().perm_c, colamd.perm_c)


def _ordering_of_navier_stokes_4x4_p5(monkeypatch):
    # Unsymmetric in value, diagonal of both signs: COLAMD, counted once a
    # factorization, and the solve still the JAX package's.
    jsol, _ = _solve_capturing(jf, jsolve_mod, monkeypatch, *_navier_stokes_4x4(jf, jflow))
    tracer.reset()
    tracer.enable()
    try:
        tsol, _ = _solve_capturing(tf, tsolve_mod, monkeypatch, *_navier_stokes_4x4(tf, tflow))
        factorizations = sum(
            calls for path, (calls, _) in tracer.stages.items() if path.endswith("/superlu")
        )
        counts = (tracer.total("superlu_min_degree"), tracer.total("superlu_colamd"))
    finally:
        tracer.disable()
        tracer.reset()
    assert factorizations >= 1 and counts == (0, factorizations)
    assert rel(tsol, jsol) <= 1e-10


@pytest.mark.parametrize(
    "case",
    [
        _ordering_of_mixed_poisson_16x16_p8,
        _ordering_of_a_zero_diagonal_saddle,
        _ordering_of_stokes_4x4_p8,
        _ordering_of_navier_stokes_4x4_p5,
    ],
    ids=["mixed_poisson_16x16_p8", "zero_diagonal_saddle", "stokes_4x4_p8", "navier_stokes_4x4_p5"],
)
def test_trace_column_ordering_follows_the_diagonal(case, monkeypatch):
    case(monkeypatch)


def test_golden_fixture_through_schur_direct():
    """4x4 p=3 mixed Poisson through static condensation, against the
    solution assembled from independent masses and a SciPy saddle solve."""
    from pathlib import Path

    from mfv2d_torch.compiler import CompiledSystem as TCompiled
    from mfv2d_torch.solver.solve import (
        SystemEvaluator as TEvaluator,
        compute_linear_system as t_linear_system,
        non_linear_solve_run,
    )

    fixture = np.load(Path(__file__).parent / "golden" / "reference_fixtures.npz")

    def u_exact(x, y):
        return np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def source_exact(x, y):
        return -(np.pi**2) / 2 * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    u = tf.KFormUnknown("u", tf.UnknownFormOrder.FORM_ORDER_2)
    q = tf.KFormUnknown("q", tf.UnknownFormOrder.FORM_ORDER_1)
    system = tf.KFormSystem(
        q.weight.derivative @ u - q.weight @ q == q.weight ^ u_exact,
        u.weight @ q.derivative == -(u.weight @ source_exact),
    )
    disc = t_discretize(
        tf.examples.unit_square_mesh(4, 4, 3), system.unknown_forms, TFemCache(2), device="cpu"
    )
    evaluator = TEvaluator(disc.form_spec, TCompiled(system), disc)
    forcing, matrices, g, lagrange_vec = t_linear_system(
        disc, system, evaluator, [], [], None
    )
    solver = ti.IterativeSaddleSolver(
        disc, matrices, g, TConv(), method="schur_direct"
    )
    explicit_vec = np.concatenate((forcing, lagrange_vec))
    solution, _, _, _, _ = non_linear_solve_run(
        20, 1.0, 1e-12, 0.0, False, evaluator, explicit_vec,
        np.zeros(disc.n_dofs), np.zeros(g.shape[0]),
        float(np.abs(explicit_vec).max()), solver, g,
    )
    assert rel(solution, fixture["solution_mixed_poisson_4x4_p3"]) <= 1e-10
