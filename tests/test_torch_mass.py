"""The port's geometry, masses and M1 kernel wrapper against the JAX package.

Both packages get literally the same geometry: the JAX package's Jacobian
terms, as NumPy arrays, cross into the port through ``mfv2d_torch.interop``.
Tolerances: 1e-12 relative for the plain ports (same formulas, only the
summation order of the contractions differs), 1e-11 absolute against the
Pallas kernel and the golden masses (the tolerances of tests/test_pallas.py
and tests/test_reference_parity.py).
"""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

import mfv2d_torch.ops.mass as tmass
import mfv2d_tpu.ops.mass as jmass
from mfv2d_torch.config import config as tconfig
from mfv2d_torch.evaluation import ElementBatch
from mfv2d_torch.interop import jacobian_terms_from_numpy
from mfv2d_torch.kform import UnknownFormOrder
from mfv2d_torch.ops import geometry as tgeom
from mfv2d_torch.ops.basis import FemCache as TFemCache
from mfv2d_torch.ops.kernels import mass_edge as kernel
from mfv2d_tpu.config import config as jconfig
from mfv2d_tpu.ops import geometry as jgeom
from mfv2d_tpu.ops.basis import FemCache as JFemCache

torch.set_num_threads(1)

BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
DEFORMED = np.array([(-1.1, -0.9), (0.8, -1.2), (1.3, 1.1), (-0.7, 0.8)])
FIX = np.load(Path(__file__).parent / "golden" / "reference_fixtures.npz")


def rel(mine, ref) -> float:
    mine = np.asarray(mine)
    ref = np.asarray(ref)
    return float(np.abs(mine - ref).max()) / max(float(np.abs(ref).max()), 1e-300)


@contextmanager
def sum_factorization(mode):
    old = (jconfig.sum_factorization, tconfig.sum_factorization)
    jconfig.sum_factorization = tconfig.sum_factorization = mode
    try:
        yield
    finally:
        jconfig.sum_factorization, tconfig.sum_factorization = old


def _corners(e, seed=0, scale=0.08):
    rng = np.random.default_rng(seed)
    return np.tile(BASE, (e, 1, 1)) + scale * rng.normal(size=(e, 4, 2))


def _shared_geometry(orders, corners, order_difference=2):
    """(JAX tb, JAX jac, port tb, port jac) on the same Jacobian terms."""
    jtb = jmass.tensor_basis(JFemCache(order_difference).get_basis2d(*orders))
    ttb = tmass.tensor_basis(TFemCache(order_difference).get_basis2d(*orders))
    jjac = jmass.batch_jacobian(jtb, corners)
    tjac = jacobian_terms_from_numpy(*(np.asarray(v) for v in jjac))
    return jtb, jjac, ttb, tjac


@pytest.mark.parametrize("corners", [BASE, DEFORMED], ids=["square", "deformed"])
@pytest.mark.parametrize("orders", [(1, 1), (3, 3), (2, 4)])
def test_geometry_matches_jax(corners, orders):
    tb = tmass.tensor_basis(TFemCache(2).get_basis2d(*orders))
    xi, eta = tb.nodes_xi[None, :], tb.nodes_eta[:, None]
    for mine, ref in zip(
        tgeom.jacobian(corners, xi, eta), jgeom.jacobian(corners, xi, eta)
    ):
        assert mine.dtype == torch.float64
        assert rel(mine, ref) <= 1e-12
    for mine, ref in zip(
        tgeom.physical_coordinates(corners, xi, eta),
        jgeom.physical_coordinates(corners, xi, eta),
    ):
        assert rel(mine, ref) <= 1e-12
    batch = _corners(5, seed=3)
    jtb = jmass.tensor_basis(JFemCache(2).get_basis2d(*orders))
    for mine, ref in zip(
        tmass.batch_jacobian(tb, torch.tensor(batch)), jmass.batch_jacobian(jtb, batch)
    ):
        assert mine.shape == ref.shape and mine.is_contiguous()
        assert rel(mine, ref) <= 1e-12


@pytest.mark.parametrize("mode", ["never", "always", "auto"])
@pytest.mark.parametrize("orders", [(1, 1), (3, 3), (2, 4), (5, 5)])
def test_mass_functions_match_jax(orders, mode):
    e = 6
    corners = _corners(e, seed=sum(orders))
    jtb, jjac, ttb, tjac = _shared_geometry(orders, corners)
    rng = np.random.default_rng(7)
    scalar = rng.normal(size=(e, jtb.w.size))
    vector = rng.normal(size=(e, jtb.w.size, 2))
    ts, tv = torch.tensor(scalar), torch.tensor(vector)
    # Cross-space masses: a lower order sharing the integration rule.
    lo = (max(1, orders[0] - 1), max(1, orders[1] - 1))
    rule = JFemCache(2).get_basis2d(*orders).integration_orders
    jlo = jmass.tensor_basis(JFemCache(0).get_basis2d(*lo, *rule))
    tlo = tmass.tensor_basis(TFemCache(0).get_basis2d(*lo, *rule))
    cases = {
        "mass_node": (lambda m, tb, jac, f, v: m.mass_node(tb, jac)),
        "mass_edge": (lambda m, tb, jac, f, v: m.mass_edge(tb, jac)),
        "mass_edge_field": (lambda m, tb, jac, f, v: m.mass_edge(tb, jac, f)),
        "mass_surf": (lambda m, tb, jac, f, v: m.mass_surf(tb, jac)),
        "edge_edge_dual": (lambda m, tb, jac, f, v: m.mass_edge_edge_dual(tb, jac, f)),
        "node_edge": (lambda m, tb, jac, f, v: m.mass_node_edge(tb, jac, v, False)),
        "node_edge_t": (lambda m, tb, jac, f, v: m.mass_node_edge(tb, jac, v, True)),
        "edge_surf": (lambda m, tb, jac, f, v: m.mass_edge_surf(tb, jac, v, False)),
        "edge_surf_t": (lambda m, tb, jac, f, v: m.mass_edge_surf(tb, jac, v, True)),
    }
    doubles = {
        "node_double": "mass_node_double",
        "edge_double": "mass_edge_double",
        "surf_double": "mass_surf_double",
    }
    with sum_factorization(mode):
        for name, fn in cases.items():
            ref = np.asarray(fn(jmass, jtb, jjac, scalar, vector))
            mine = fn(tmass, ttb, tjac, ts, tv)
            assert mine.dtype == torch.float64, name
            assert mine.shape == ref.shape, name
            assert rel(mine, ref) <= 1e-12, (name, rel(mine, ref))
        for name, attr in doubles.items():
            ref = np.asarray(getattr(jmass, attr)(jlo, jtb, jjac))
            mine = getattr(tmass, attr)(tlo, ttb, tjac)
            assert mine.shape == ref.shape, name
            assert rel(mine, ref) <= 1e-12, (name, rel(mine, ref))


@pytest.mark.parametrize("orders", [(2, 2), (4, 4), (3, 5)])
def test_plain_mass_edge_matches_pallas(orders):
    from mfv2d_tpu.ops.pallas_mass import mass_edge_pallas

    rng = np.random.default_rng(1)
    e = 8
    corners = np.tile(BASE, (e, 1, 1)) + 0.05 * rng.normal(size=(e, 4, 2))
    jtb, jjac, ttb, tjac = _shared_geometry(orders, corners)
    ref = np.asarray(mass_edge_pallas(jtb, jjac, tile=4))
    mine = tmass.mass_edge(ttb, tjac).numpy()
    assert np.allclose(mine, ref, atol=1e-11, rtol=0), np.abs(mine - ref).max()


@pytest.mark.parametrize("qi", [0, 1, 2])
@pytest.mark.parametrize("orders", [(3, 3), (3, 5)])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_mass_matrices_match_golden(qi, orders, k):
    batch = ElementBatch(TFemCache(2).get_basis2d(*orders), FIX["quads"][qi][None])
    mine = batch.mass(UnknownFormOrder(k + 1), False)[0].numpy()
    assert rel(mine, FIX[f"imass{k}_q{qi}_p{orders[0]}{orders[1]}"]) < 1e-11


def test_inverse_mass():
    batch = ElementBatch(TFemCache(2).get_basis2d(3, 2), _corners(3, seed=11))
    for order in UnknownFormOrder:
        m = batch.mass(order, False)
        eye = torch.eye(m.shape[-1], dtype=torch.float64)
        assert torch.allclose(batch.mass(order, True) @ m, eye.expand_as(m), atol=1e-10)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    jtb, jjac, ttb, tjac = _shared_geometry((4, 4), _corners(5, seed=2))
    before = kernel.launches
    out = kernel.mass_edge(ttb, tjac)
    assert kernel.launches == before
    assert torch.equal(out, tmass.mass_edge(ttb, tjac))
    batch = ElementBatch(TFemCache(2).get_basis2d(4, 4), _corners(5, seed=2))
    batch.mass(UnknownFormOrder.FORM_ORDER_1, False)
    assert kernel.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, ttb, tjac = _shared_geometry((3, 3), _corners(4, seed=5))
    with pytest.raises(TypeError):
        kernel.mass_edge(ttb, type(tjac)(*(t.to(torch.float16) for t in tjac)))
    with pytest.raises(ValueError, match="must be"):
        kernel.mass_edge(ttb, type(tjac)(*(t[:, :-1] for t in tjac)))
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.cat([tjac.j00, tjac.j00], dim=1)[:, ::2]
        kernel.mass_edge(ttb, tjac._replace(j00=strided))
    with pytest.raises(ValueError, match="match det"):
        kernel.mass_edge(ttb, tjac._replace(j01=tjac.j01.to(torch.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for orders in [(2, 2), (4, 4), (3, 5)]:
        _, _, ttb, tjac = _shared_geometry(orders, _corners(37, seed=4))
        jac = type(tjac)(*(t.to("cuda", dtype) for t in tjac))
        before = kernel.launches
        out = kernel.mass_edge(ttb, jac)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert rel(out.cpu(), tmass.mass_edge(ttb, jac).cpu()) <= tol
