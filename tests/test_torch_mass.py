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
    tjac = jacobian_terms_from_numpy(*(np.asarray(v) for v in jjac), device="cpu")
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


@pytest.mark.parametrize("orders", [(2, 2), (4, 4), (3, 5), (9, 9), (10, 10)])
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
    batch = ElementBatch(TFemCache(2).get_basis2d(*orders), FIX["quads"][qi][None], "cpu")
    mine = batch.mass(UnknownFormOrder(k + 1), False)[0].numpy()
    assert rel(mine, FIX[f"imass{k}_q{qi}_p{orders[0]}{orders[1]}"]) < 1e-11


def test_inverse_mass():
    batch = ElementBatch(TFemCache(2).get_basis2d(3, 2), _corners(3, seed=11), "cpu")
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
    batch = ElementBatch(TFemCache(2).get_basis2d(4, 4), _corners(5, seed=2), "cpu")
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


# Orders above the old whole-table cap (p=8 with over-integration 3), square
# and anisotropic either way.
HIGH_ORDERS = [(9, 9), (10, 10), (12, 12), (9, 3), (3, 10)]


@pytest.mark.parametrize("orders", HIGH_ORDERS)
def test_cpu_wrapper_takes_high_orders(orders):
    """The wrapper applies no card limit to CPU tensors: with the solver's
    default over-integration it returns the plain version, which agrees with
    the JAX package."""
    jtb, jjac, ttb, tjac = _shared_geometry(orders, _corners(3, seed=9), order_difference=3)
    out = kernel.mass_edge(ttb, tjac)
    assert torch.equal(out, tmass.mass_edge(ttb, tjac))
    assert rel(out, jmass.mass_edge(jtb, jjac)) <= 1e-12


def _plan_shapes(p1, p2, over):
    nq = (p1 + 1 + over) * (p2 + 1 + over)
    return p1 * (p2 + 1), (p1 + 1) * p2, nq


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("over", range(5))
def test_launch_plan_fits_every_order(over, dtype):
    """For every order pair up to (24, 24) the plan stays inside the card's
    shared memory, its chunks cover every quadrature point, and it is one
    the kernel's entry point accepts."""
    size = 8 if dtype == torch.float64 else 4
    for p1 in range(1, 25):
        for p2 in range(1, 25):
            n_h, n_v, nq = _plan_shapes(p1, p2, over)
            plan = kernel.launch_plan(n_h, n_v, nq, dtype)
            n1_pad = -(-n_h // 8) * 8 + -(-n_v // 8) * 8
            tile_bytes = -(-len(plan.tiles) // 4) * 16
            ring = plan.stages * plan.chunk * plan.ld
            metric = 2 * plan.group * 3 * plan.nq_pad
            assert plan.smem_bytes == (ring + metric) * size + tile_bytes
            assert plan.smem_bytes <= kernel.SMEM_LIMIT == 232448, (p1, p2)
            assert plan.ld >= n1_pad and plan.ld % 16 == 4
            assert plan.nq_pad >= nq and plan.nq_pad % plan.chunk == 0
            assert plan.chunk % 4 == 0 and plan.chunk >= 4
            assert (plan.stages, plan.chunk) == (1, plan.nq_pad) or plan.stages == 3
            assert (plan.mr, plan.nc) in kernel.WARP_TILES and plan.mr % 2 == 0
            assert plan.group >= 1 and 1 <= plan.warps <= 16 and plan.tiles


def test_launch_plan_streams_above_the_old_cap():
    """p=8 keeps its table resident; p=10 and p=12 (over-integration 3, f64),
    which the whole-table layout could not hold, go through the ring."""
    resident = kernel.launch_plan(*_plan_shapes(8, 8, 3), torch.float64)
    assert resident.stages == 1 and resident.chunk == resident.nq_pad == 144
    for p in (10, 12):
        n_h, n_v, nq = _plan_shapes(p, p, 3)
        assert (2 * nq * n_h + 3 * nq) * 8 > kernel.SMEM_LIMIT
        plan = kernel.launch_plan(n_h, n_v, nq, torch.float64)
        assert plan.stages == 3 and plan.chunk < plan.nq_pad


def _walk_plan(tb, plan, k_rows):
    """M1 of one element the way the kernel walks it: tile by tile and block
    by block over the padded table, with the kernel's masks, offsets and
    direct and mirrored stores.  Returns the matrix and the number of times
    each entry was stored."""
    table = kernel.padded_table(tb, plan)
    n_h, n_v = tb.bh.shape[0], tb.bv.shape[0]
    n_hp = -(-n_h // 8) * 8
    n1 = n_h + n_v
    out = np.zeros((n1, n1))
    stored = np.zeros((n1, n1), int)
    k_pad = np.zeros((3, plan.nq_pad))
    k_pad[:, : k_rows.shape[1]] = k_rows  # hh, vv, hv
    for code in plan.tiles:
        quad = code >> 28
        rb0 = ((code >> 14) & 0x3FFF) * plan.mr
        cb0 = (code & 0x3FFF) * plan.nc
        rows_v, cols_v = bool(quad & 2), bool((quad + 1) & 2)
        q_rows, q_cols = (n_v if rows_v else n_h), (n_v if cols_v else n_h)
        row_off, col_off = (n_h if rows_v else 0), (n_h if cols_v else 0)
        diagonal = rows_v == cols_v
        k = k_pad[(1 if rows_v else 0) if rows_v == cols_v else 2]
        for i in range(plan.mr):
            for j in range(plan.nc):
                rb, cb = rb0 + i, cb0 + j
                # The MMA of the row pair that block rb is the upper or lower
                # half of runs if its upper half is needed.
                upper = rb - i % 2
                if upper >= -(-q_rows // 8) or cb >= -(-q_cols // 8) or (diagonal and cb < upper):
                    continue
                if rb >= -(-q_rows // 8) or (diagonal and cb < rb):
                    continue  # the lower half is computed and not stored
                row_at = (n_hp if rows_v else 0) + rb * 8
                col_at = (n_hp if cols_v else 0) + cb * 8
                block = (table[:, row_at : row_at + 8] * k[:, None]).T @ table[:, col_at : col_at + 8]
                mirror = quad == kernel.HV or (diagonal and cb > rb)
                for g in range(8):
                    for c8 in range(8):
                        r, c = rb * 8 + g, cb * 8 + c8
                        if r >= q_rows or c >= q_cols:
                            continue
                        out[row_off + r, col_off + c] = block[g, c8]
                        stored[row_off + r, col_off + c] += 1
                        if mirror:
                            out[col_off + c, row_off + r] = block[g, c8]
                            stored[col_off + c, row_off + r] += 1
    return out, stored


@pytest.mark.parametrize(
    "orders",
    [(1, 1), (2, 3), (3, 3), (4, 4), (1, 4), (5, 5), (6, 6), (7, 7), (8, 8),
     (9, 9), (9, 3), (3, 10), (10, 10), (12, 12)],
)
def test_launch_plan_tiles_store_every_entry_once(orders):
    """The kernel's tiling, walked in NumPy over the padded table, stores each
    entry of M1 exactly once and gives the plain version's matrix."""
    _, _, ttb, tjac = _shared_geometry(orders, _corners(1, seed=6), order_difference=3)
    n_h, n_v, nq = ttb.bh.shape[0], ttb.bv.shape[0], ttb.w.size
    plan = kernel.launch_plan(n_h, n_v, nq, torch.float64)
    k_rows = np.stack([k[0].numpy() for k in tmass._edge_metric(tjac, ttb.w)])
    out, stored = _walk_plan(ttb, plan, k_rows)
    assert (stored == 1).all()
    assert rel(out, tmass.mass_edge(ttb, tjac)[0]) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for orders in [(2, 2), (4, 4), (3, 5), (8, 8), (9, 9), (10, 10)]:
        _, _, ttb, tjac = _shared_geometry(
            orders, _corners(37, seed=4), order_difference=3
        )
        jac = type(tjac)(*(t.to("cuda", dtype) for t in tjac))
        before = kernel.launches
        out = kernel.mass_edge(ttb, jac)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert rel(out.cpu(), tmass.mass_edge(ttb, jac).cpu()) <= tol
