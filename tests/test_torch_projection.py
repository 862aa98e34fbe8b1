"""The port's L2 projectors and projections against the JAX package.

The element projectors (per form, between two order spaces on deformed
quads), the projection appliers, the reference inclusion matrix and the
batched dual and primal DoFs must agree with the JAX package to 1e-12
relative; the mixed-Poisson solve on a non-conforming, mixed-order mesh to
1e-10 through the direct and the static-condensation solvers.
"""

import numpy as np
import pytest
import torch

import mfv2d_torch as tf
import mfv2d_torch.evaluation as tevaluation
import mfv2d_torch.projection as tprojection
import mfv2d_tpu as jf
import mfv2d_tpu.evaluation as jevaluation
import mfv2d_tpu.projection as jprojection
from mfv2d_torch.kform import UnknownFormOrder as TOrder
from mfv2d_torch.models import poisson as tpoisson
from mfv2d_torch.ops.basis import FemCache as TFemCache
from mfv2d_torch.system import ElementFormSpecification as TSpec
from mfv2d_tpu.kform import UnknownFormOrder as JOrder
from mfv2d_tpu.models import poisson as jpoisson
from mfv2d_tpu.ops.basis import FemCache as JFemCache
from mfv2d_tpu.system import ElementFormSpecification as JSpec

torch.set_num_threads(1)

BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
FORMS = [("a", 1), ("b", 2), ("c", 3)]  # 0-, 1- and 2-forms


def rel(mine, ref) -> float:
    mine = np.asarray(mine)
    ref = np.asarray(ref)
    assert mine.shape == ref.shape
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


def _corners(e: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.tile(BASE, (e, 1, 1)) + 0.12 * rng.normal(size=(e, 4, 2))


def _batches(orders_in, orders_out, corners, int_orders):
    tcache, jcache = TFemCache(0), JFemCache(0)
    return (
        tevaluation.ElementBatch(tcache.get_basis2d(*orders_in, *int_orders), corners, "cpu"),
        tevaluation.ElementBatch(tcache.get_basis2d(*orders_out, *int_orders), corners, "cpu"),
        jevaluation.ElementBatch(jcache.get_basis2d(*orders_in, *int_orders), corners),
        jevaluation.ElementBatch(jcache.get_basis2d(*orders_out, *int_orders), corners),
    )


# (orders in, orders out, integration orders): p -> p+1, p -> p+2, anisotropic
# both ways, and down.
PROJECTIONS = [
    ((3, 3), (4, 4), (7, 7)),
    ((2, 2), (4, 4), (7, 7)),
    ((2, 4), (3, 5), (6, 8)),
    ((4, 2), (4, 3), (7, 6)),
    ((5, 5), (3, 3), (8, 8)),
]


@pytest.mark.parametrize("orders_in, orders_out, int_orders", PROJECTIONS)
def test_element_projector_matches_jax(orders_in, orders_out, int_orders, monkeypatch):
    """Per-form projectors of 0-, 1- and 2-forms, whole and in chunks."""
    corners = _corners(7, seed=sum(orders_in) + 10 * sum(orders_out))
    t_in, t_out, j_in, j_out = _batches(orders_in, orders_out, corners, int_orders)
    tspec, jspec = TSpec(*FORMS), JSpec(*FORMS)
    ref = jevaluation.jit_element_projector(jspec, j_in, j_out)
    whole = tevaluation.compute_element_projector(tspec, t_in, t_out)
    monkeypatch.setattr(tevaluation, "PROJECTOR_CHUNK", 3)
    chunked = tevaluation.element_projector(tspec, t_in, t_out)
    for i, r in enumerate(ref):
        assert rel(whole[i].numpy(), r) <= 1e-12, FORMS[i]
        assert rel(chunked[i].numpy(), r) <= 1e-12, FORMS[i]
    with pytest.raises(ValueError, match="integration rules"):
        tevaluation.compute_element_projector(
            tspec, t_in, tevaluation.ElementBatch(
                TFemCache(0).get_basis2d(*orders_out), corners, "cpu"
            ),
        )


@pytest.mark.parametrize("orders_in, orders_out, int_orders", PROJECTIONS[:3])
def test_project_between_and_roundtrip_match_jax(orders_in, orders_out, int_orders):
    corners = _corners(6, seed=3)
    t_in, t_out, j_in, j_out = _batches(orders_in, orders_out, corners, int_orders)
    tspec, jspec = TSpec(*FORMS), JSpec(*FORMS)
    rng = np.random.default_rng(5)
    dofs = rng.normal(size=(6, tspec.total_size(*orders_in)))
    ref = np.asarray(jevaluation.jit_project_between(jspec, j_in, j_out, dofs))
    assert rel(tevaluation.project_between(tspec, t_in, t_out, dofs).numpy(), ref) <= 1e-12
    # Round trip of a field of the other space through this one.
    fine = rng.normal(size=(6, tspec.total_size(*orders_out)))
    ref_err = np.asarray(
        jevaluation.jit_projection_roundtrip_error(jspec, j_out, j_in, fine)
    )
    err = tevaluation.projection_roundtrip_error(tspec, t_out, t_in, fine).numpy()
    assert rel(err, ref_err) <= 1e-12
    # A coarse field survives the trip up and back down exactly.
    back = tevaluation.projection_roundtrip_error(tspec, t_in, t_out, dofs).numpy()
    assert np.abs(back).max() <= 1e-11 * np.abs(dofs).max()


@pytest.mark.parametrize(
    "orders_in, orders_out", [((2, 2), (3, 3)), ((3, 2), (5, 4)), ((4, 4), (4, 4))]
)
def test_reference_inclusion_matrix_matches_jax(orders_in, orders_out):
    tspec, jspec = TSpec(*FORMS), JSpec(*FORMS)
    ref = jevaluation.reference_inclusion_matrix(jspec, orders_in, orders_out)
    mine = tevaluation.reference_inclusion_matrix(tspec, orders_in, orders_out, device="cpu")
    assert rel(mine, ref) <= 1e-12
    with pytest.raises(ValueError, match="nested"):
        tevaluation.reference_inclusion_matrix(tspec, orders_out, (1, 1), device="cpu")


def _field(order):
    if order == 2:
        return lambda x, y: np.stack((np.sin(x) * y, x * x - 0.3 * y), axis=-1)
    return lambda x, y: np.cos(x) * y + 0.5 * x * x


@pytest.mark.parametrize("order", [1, 2, 3])  # 0-, 1- and 2-forms
@pytest.mark.parametrize("orders", [(3, 3), (2, 5)])
def test_dual_and_primal_dofs_match_jax(order, orders):
    corners = _corners(5, seed=order + 6)
    tbatch = tevaluation.ElementBatch(TFemCache(3).get_basis2d(*orders), corners, "cpu")
    jbatch = jevaluation.ElementBatch(JFemCache(3).get_basis2d(*orders), corners)
    fn = _field(order)
    values = tprojection.evaluate_function_on_batch(tbatch, fn)
    ref_dual = np.asarray(
        jprojection.element_dual_dofs_batched(JOrder(order), jbatch, values)
    )
    dual = tprojection.element_dual_dofs_batched(TOrder(order), tbatch, values).numpy()
    assert rel(dual, ref_dual) <= 1e-12
    # The host projection of the same callable gives the same dual DoFs.
    assert rel(tprojection.element_dual_dofs(TOrder(order), tbatch, fn), ref_dual) <= 1e-12
    ref_primal = np.asarray(jprojection.element_primal_dofs(JOrder(order), jbatch, fn))
    primal = tprojection.element_primal_dofs(TOrder(order), tbatch, fn).numpy()
    assert rel(primal, ref_primal) <= 1e-12


def _hanging_mesh(mf):
    """3x3 mixed Poisson mesh at p=3 with the centre split into (4, 4) and
    (3, 3) children (hanging nodes on all four sides) and a corner leaf
    raised to (5, 4)."""
    mesh = mf.examples.unit_square_mesh(3, 3, 3)
    mesh.split_element(4, (4, 4), (3, 3), (4, 4), (3, 3))
    mesh.set_leaf_orders(0, 5, 4)
    return mesh


@pytest.mark.parametrize("linear_solver", ["direct", "schur_direct"])
def test_nonconforming_mixed_order_solve_matches_jax(linear_solver):
    """Hanging nodes and mixed orders: the port's constraints and both
    solvers against the JAX package's direct solve, to 1e-10."""
    tmodel, jmodel = tpoisson.mixed_poisson(), jpoisson.mixed_poisson()
    tgrids, tstats, _ = tf.solve_system_2d(
        _hanging_mesh(tf),
        tf.SystemSettings(tmodel.system),
        tf.SolverSettings(linear_solver=linear_solver),
        recon_order=5,
        device="cpu",
    )
    jgrids, jstats, _ = jf.solve_system_2d(
        _hanging_mesh(jf), jf.SystemSettings(jmodel.system), recon_order=5
    )
    assert tstats.element_orders == jstats.element_orders == {
        (3, 3): 9, (4, 4): 2, (5, 4): 1
    }
    assert tstats.n_total_dofs == jstats.n_total_dofs
    assert tstats.n_lagrange == jstats.n_lagrange
    for name in ("q", "u"):
        assert rel(tgrids[-1].point_data[name], jgrids[-1].point_data[name]) <= 1e-10, name


@pytest.mark.cuda
def test_projector_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the M1 kernel has no CPU mode")
    from mfv2d_torch.ops.kernels import mass_edge

    corners = _corners(600, seed=2)
    tspec = TSpec(*FORMS)
    cache = TFemCache(0)
    for orders_in, orders_out, int_orders in PROJECTIONS:
        cpu = [
            tevaluation.ElementBatch(cache.get_basis2d(*o, *int_orders), corners, "cpu")
            for o in (orders_in, orders_out)
        ]
        card = [
            tevaluation.ElementBatch(cache.get_basis2d(*o, *int_orders), corners, "cuda")
            for o in (orders_in, orders_out)
        ]
        before = mass_edge.launches
        on_card = tevaluation.element_projector(tspec, *card)
        torch.cuda.synchronize()
        assert mass_edge.launches == before + 2  # two chunks of 512 and 88
        for mine, ref in zip(on_card, tevaluation.element_projector(tspec, *cpu)):
            assert rel(mine.cpu().numpy(), ref.numpy()) <= 1e-12
