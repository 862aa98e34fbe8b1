"""The port's geometry, masses and M1 kernel wrapper against the JAX package.

Both packages get literally the same geometry: the JAX package's Jacobian
terms, as NumPy arrays, cross into the port through ``mfv2d_torch.interop``.
Tolerances: 1e-12 relative for the plain ports (same formulas, only the
summation order of the contractions differs), 1e-11 absolute against the
Pallas kernel and the golden masses (the tolerances of tests/test_pallas.py
and tests/test_reference_parity.py).
"""

import functools
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


@functools.cache
def _bases(orders, order_difference):
    """The JAX package's and the port's tensor bases of ``orders``."""
    jtb = jmass.tensor_basis(JFemCache(order_difference).get_basis2d(*orders))
    ttb = tmass.tensor_basis(TFemCache(order_difference).get_basis2d(*orders))
    return jtb, ttb


def _shared_geometry(orders, corners, order_difference=2):
    """(JAX tb, JAX jac, port tb, port jac) on the same Jacobian terms."""
    jtb, ttb = _bases(tuple(orders), order_difference)
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


# The card the plans are made for: an H100's 132 SMs and what each holds,
# which the wrapper reads from the device.
CARD = kernel.H100


def _check_panel_plan(plan, n_h, n_v, nq, size):
    """What the C entry point and the panel kernel take of a panel plan."""
    rows, cols = plan.panel
    assert plan.route == "panel" and (rows, cols) in kernel.PANELS
    assert plan.warps == rows * cols and plan.group == 1 and plan.stages == 3
    assert plan.slice_ld >= (rows * plan.mr + cols * plan.nc) * 8 and plan.slice_ld % 16 == 4
    assert plan.chunk in kernel.CHUNKS and plan.nq_pad == -(-nq // plan.chunk) * plan.chunk
    assert plan.smem_bytes == (3 * plan.chunk * plan.slice_ld + plan.nq_pad) * size
    assert plan.smem_bytes <= kernel.SMEM_LIMIT == 232448, (n_h, n_v, plan.panel)
    nb_h, nb_v = -(-n_h // 8), -(-n_v // 8)
    assert plan.ld == kernel.element_plan(n_h, n_v, nq, torch.float64).ld
    assert plan.tiles == kernel.tile_list(nb_h, nb_v, rows * plan.mr, cols * plan.nc)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("over", range(5))
def test_launch_plan_fits_every_order(over, dtype):
    """For every order pair up to (24, 24) the plan stays inside the card's
    shared memory, its chunks cover every quadrature point, and it is one
    the kernel's entry point accepts: on the element route at a batch that
    fills the card, and on the route that one element takes."""
    size = 8 if dtype == torch.float64 else 4
    for p1 in range(1, 25):
        for p2 in range(1, 25):
            n_h, n_v, nq = _plan_shapes(p1, p2, over)
            plan = kernel.launch_plan(n_h, n_v, nq, dtype, 4096, CARD)
            assert plan == kernel.element_plan(n_h, n_v, nq, dtype)
            n1_pad = -(-n_h // 8) * 8 + -(-n_v // 8) * 8
            tile_bytes = -(-len(plan.tiles) // 4) * 16
            ring = plan.stages * plan.chunk * plan.ld
            metric = 2 * plan.group * 3 * plan.nq_pad
            assert plan.route == "element" and plan.as_ints()[9:] == [0, 0, 0, 0]
            assert plan.smem_bytes == (ring + metric) * size + tile_bytes
            assert plan.smem_bytes <= kernel.SMEM_LIMIT == 232448, (p1, p2)
            assert plan.ld >= n1_pad and plan.ld % 16 == 4
            assert plan.nq_pad >= nq and plan.nq_pad % plan.chunk == 0
            assert plan.chunk % 4 == 0 and plan.chunk >= 4
            assert (plan.stages, plan.chunk) == (1, plan.nq_pad) or plan.stages == 3
            assert (plan.mr, plan.nc) in kernel.WARP_TILES and plan.mr % 2 == 0
            assert plan.group >= 1 and 1 <= plan.warps <= 16 and plan.tiles
            one = kernel.launch_plan(n_h, n_v, nq, dtype, 1, CARD)
            if one.route == "panel":
                _check_panel_plan(one, n_h, n_v, nq, size)
                assert (one.mr, one.nc) == (plan.mr, plan.nc)
            else:
                assert one == plan


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("panel", kernel.PANELS, ids=lambda p: f"{p[0]}x{p[1]}")
def test_panel_plans_fit_shared_memory(panel, dtype):
    """Every panel, forced at every order to (24, 24) with the solver's
    over-integration, fits ``SMEM_LIMIT`` with a ring the entry point takes."""
    size = 8 if dtype == torch.float64 else 4
    for p1 in range(1, 25):
        for p2 in range(1, 25):
            n_h, n_v, nq = _plan_shapes(p1, p2, 3)
            tile = kernel.element_plan(n_h, n_v, nq, dtype)
            plan = kernel.panel_plan(
                n_h, n_v, nq, dtype, tile.mr, tile.nc, 1, CARD, panel=panel
            )
            assert plan.panel == panel
            _check_panel_plan(plan, n_h, n_v, nq, size)


def test_launch_plan_streams_above_the_old_cap():
    """p=8 keeps its table resident; p=10 and p=12 (over-integration 3, f64),
    which the whole-table layout could not hold, go through the ring."""
    resident = kernel.launch_plan(*_plan_shapes(8, 8, 3), torch.float64, 4096, CARD)
    assert resident.stages == 1 and resident.chunk == resident.nq_pad == 144
    for p in (10, 12):
        n_h, n_v, nq = _plan_shapes(p, p, 3)
        assert (2 * nq * n_h + 3 * nq) * 8 > kernel.SMEM_LIMIT
        plan = kernel.launch_plan(n_h, n_v, nq, torch.float64, 4096, CARD)
        assert plan.stages == 3 and plan.chunk < plan.nq_pad


# The element-route plans of the batches that fill the card, field for field
# as they were before the panel route: (n_h, n_v, nq, E) -> (mr, nc, ld,
# nq_pad, chunk, stages, group, warps), smem_bytes, number and sum of the tile
# codes; f64, then f32.  p=4 and p=8 at E=4096 (phases 4 and 8), p=10 at
# E=1024, p=8 and p=10 at nq=144, E=4096 (VMS config 5), p=8 at E=2048 (a
# rank's half of config 5's mesh).
LARGE_BATCH_PLANS = {
    (20, 20, 64, 4096): [((4, 3, 52, 64, 64, 1, 8, 8), 51216, 3, 805306368),
                         ((4, 3, 52, 64, 64, 1, 8, 8), 25616, 3, 805306368)],
    (72, 72, 144, 4096): [((4, 3, 148, 144, 144, 1, 8, 16), 225888, 21, 5637423129),
                          ((4, 3, 148, 144, 144, 1, 8, 16), 112992, 21, 5637423129)],
    (72, 72, 144, 2048): [((4, 3, 148, 144, 144, 1, 8, 16), 225888, 21, 5637423129),
                          ((4, 3, 148, 144, 144, 1, 8, 16), 112992, 21, 5637423129)],
    (110, 110, 196, 1024): [((4, 3, 228, 224, 32, 3, 4, 16), 218304, 46, 12348948586),
                            ((4, 3, 228, 196, 196, 1, 8, 16), 216576, 46, 12348948586)],
    (110, 110, 144, 4096): [((4, 3, 228, 160, 32, 3, 4, 16), 206016, 46, 12348948586),
                            ((4, 3, 228, 144, 144, 1, 8, 16), 159168, 46, 12348948586)],
}


@pytest.mark.parametrize("shape", list(LARGE_BATCH_PLANS), ids=lambda s: "x".join(map(str, s)))
def test_launch_plan_keeps_todays_plan_at_large_batches(shape):
    """The batches that fill the card keep the element route's plan as it
    was before the panel route, field for field."""
    *dims, n_elem = shape
    for dtype, (fields, smem, n_tiles, code_sum) in zip(
        (torch.float64, torch.float32), LARGE_BATCH_PLANS[shape]
    ):
        plan = kernel.launch_plan(*dims, dtype, n_elem, CARD)
        assert plan.route == "element" and plan.panel == (0, 0) and plan.slice_ld == 0
        assert tuple(plan[:8]) == fields and plan.smem_bytes == smem
        assert (len(plan.tiles), sum(plan.tiles)) == (n_tiles, code_sum)


@pytest.mark.parametrize(
    "p, n_elem, route, panel, rounds",
    [
        (16, 16, "panel", (4, 4), 3),  # phase 13: 336 items; whole elements take 43 rounds
        (16, 1, "panel", (2, 2), 1),
        (10, 1, "panel", (2, 2), 1),  # the VMS inclusion's reference element
        (16, 8, "panel", (2, 2), 2),  # a tie of rounds goes to the smaller panel
        (14, 64, "panel", (4, 4), 8),
        (14, 128, "element", (0, 0), 9),  # 128 blocks of whole elements: 9 rounds, panels 10
        (8, 1024, "element", (0, 0), 11),  # 128 blocks of 8 elements
    ],
)
def test_launch_plan_takes_panels_below_the_card(p, n_elem, route, panel, rounds):
    """The route and panel the wrapper picks where the sweep of
    tools/mass_edge_ablation.py measured both routes, with the rounds of
    warp tiles its choice compares."""
    n_h, n_v, nq = _plan_shapes(p, p, 3)
    plan = kernel.launch_plan(n_h, n_v, nq, torch.float64, n_elem, CARD)
    element = kernel.element_plan(n_h, n_v, nq, torch.float64)
    assert (plan.route, plan.panel) == (route, panel)
    assert kernel.rounds(plan, n_elem, CARD) == rounds <= kernel.rounds(element, n_elem, CARD)
    if route == "panel":
        assert plan.chunk == 32 and -(-n_elem // element.group) < CARD.sms
        other = next(shape for shape in kernel.PANELS if shape != panel)
        forced = kernel.panel_plan(
            n_h, n_v, nq, torch.float64, element.mr, element.nc, n_elem, CARD, panel=other
        )
        assert (rounds, plan.warps) < (kernel.rounds(forced, n_elem, CARD), forced.warps)


def _walk_plan(tb, plan, k_rows):
    """M1 of a batch the way the kernel walks it, on either route: warp tile
    by warp tile and block by block over what the block holds of the padded
    table, with the kernel's masks, offsets and direct and mirrored stores.
    ``k_rows`` is ``[E, 3, nq]`` (hh, vv, hv).  The element route reads the
    whole table; a panel route item, (panel, element), reads its slice: the
    panel's row range and column range, cut at the end of the quadrant, in
    a stage row of ``slice_ld`` entries.  Every item of a panel is walked at
    once over the batch (its element only picks the metric row).  What a
    block did not load, and the table past ``ld``, reads NaN, so a stored
    entry that depends on it shows.  Returns the matrices and how many times
    each entry was stored (the same for every element)."""
    table = kernel.padded_table(tb, plan)
    n_h, n_v, nq = tb.bh.shape[0], tb.bv.shape[0], tb.w.size
    n_hp = -(-n_h // 8) * 8
    n1 = n_h + n_v
    n_elem = k_rows.shape[0]
    out = np.zeros((n_elem, n1, n1))
    stored = np.zeros((n1, n1), int)
    k_pad = np.zeros((n_elem, 3, plan.nq_pad))
    k_pad[:, :, :nq] = k_rows
    mr, nc = plan.mr, plan.nc

    def quadrant(quad):
        rows_v, cols_v = bool(quad & 2), bool((quad + 1) & 2)
        q_rows, q_cols = (n_v if rows_v else n_h), (n_v if cols_v else n_h)
        return rows_v, cols_v, q_rows, q_cols, -(-q_rows // 8), -(-q_cols // 8)

    def walk_tile(quad, rb0, cb0, rows, cols):
        """One warp tile from blocks (rb0, cb0) of its quadrant, its table
        columns ``rows`` and ``cols`` ([nq_pad, 8 mr] and [nq_pad, 8 nc])."""
        rows_v, cols_v, q_rows, q_cols, nb_rows, nb_cols = quadrant(quad)
        row_off, col_off = (n_h if rows_v else 0), (n_h if cols_v else 0)
        diagonal = rows_v == cols_v
        k = k_pad[:, (1 if rows_v else 0) if diagonal else 2]
        tile = (rows.T[None] * k[:, None, :]) @ cols  # [E, 8 mr, 8 nc]
        for i in range(mr):
            for j in range(nc):
                rb, cb = rb0 + i, cb0 + j
                # The MMA of the row pair that block rb is the upper or lower
                # half of runs if its upper half is needed.
                upper = rb - i % 2
                if upper >= nb_rows or cb >= nb_cols or (diagonal and cb < upper):
                    continue
                if rb >= nb_rows or (diagonal and cb < rb):
                    continue  # the lower half is computed and not stored
                r0, c0 = rb * 8, cb * 8
                nr, nk = min(8, q_rows - r0), min(8, q_cols - c0)
                block = tile[:, i * 8 : i * 8 + nr, j * 8 : j * 8 + nk]
                at = np.s_[row_off + r0 : row_off + r0 + nr, col_off + c0 : col_off + c0 + nk]
                out[(slice(None), *at)] = block
                stored[at] += 1
                if quad == kernel.HV or (diagonal and cb > rb):
                    mirror = np.s_[col_off + c0 : col_off + c0 + nk, row_off + r0 : row_off + r0 + nr]
                    out[(slice(None), *mirror)] = block.transpose(0, 2, 1)
                    stored[mirror] += 1

    if plan.route == "element":
        padded = np.full((plan.nq_pad, plan.ld + 8 * max(mr, nc)), np.nan)
        padded[:, : plan.ld] = table
        for code in plan.tiles:
            quad = code >> 28
            rows_v, cols_v = quadrant(quad)[:2]
            rb0, cb0 = ((code >> 14) & 0x3FFF) * mr, (code & 0x3FFF) * nc
            row_at = (n_hp if rows_v else 0) + rb0 * 8
            col_at = (n_hp if cols_v else 0) + cb0 * 8
            walk_tile(quad, rb0, cb0, padded[:, row_at : row_at + 8 * mr],
                      padded[:, col_at : col_at + 8 * nc])
        return out, stored

    span_r, span_c = plan.panel[0] * mr, plan.panel[1] * nc
    vec = 2  # f64 entries a 16-byte copy
    for code in plan.tiles:
        quad = code >> 28
        rows_v, cols_v, _, _, nb_rows, nb_cols = quadrant(quad)
        pr0, pc0 = ((code >> 14) & 0x3FFF) * span_r, (code & 0x3FFF) * span_c
        row_from = (n_hp if rows_v else 0) + pr0 * 8
        col_from = (n_hp if cols_v else 0) + pc0 * 8
        row_len = min(span_r, nb_rows - pr0) * 8
        col_len = min(span_c, nb_cols - pc0) * 8
        one_range = row_from == col_from and row_len == col_len
        col_base = 0 if one_range else span_r * 8
        assert row_len > 0 and col_len > 0 and row_len % vec == col_len % vec == 0
        assert col_base + span_c * 8 <= plan.slice_ld
        stage = np.full((plan.nq_pad, plan.slice_ld), np.nan)
        stage[:, :row_len] = table[:, row_from : row_from + row_len]
        if not one_range:
            stage[:, col_base : col_base + col_len] = table[:, col_from : col_from + col_len]
        for warp in range(plan.warps):
            tr, tc = divmod(warp, plan.panel[1])
            rb0, cb0 = pr0 + tr * mr, pc0 + tc * nc
            row_at = (rb0 - pr0) * 8
            col_at = col_base + (cb0 - pc0) * 8
            walk_tile(quad, rb0, cb0, stage[:, row_at : row_at + 8 * mr],
                      stage[:, col_at : col_at + 8 * nc])
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
    plan = kernel.launch_plan(n_h, n_v, nq, torch.float64, 4096, CARD)
    assert plan.route == "element"
    k_rows = np.stack([k.numpy() for k in tmass._edge_metric(tjac, ttb.w)], axis=1)
    out, stored = _walk_plan(ttb, plan, k_rows)
    assert (stored == 1).all()
    assert rel(out[0], tmass.mass_edge(ttb, tjac)[0]) <= 1e-12


# The walk's batches: a case of E takes the first E elements of one batch
# of WALK_BATCH an order, walked once for each plan that the batches take.
WALK_BATCHES = (1, 4, 16, 64)
WALK_BATCH = max(WALK_BATCHES)


@functools.cache
def _walk_batch(orders):
    """WALK_BATCH elements at ``orders``: the port's tensor basis, the
    metric rows ``[E, 3, nq]`` and M1 of the plain version and of the JAX
    package's mass_edge on the same corners."""
    jtb, jjac, ttb, tjac = _shared_geometry(
        orders, _corners(WALK_BATCH, seed=sum(orders)), order_difference=3
    )
    k_rows = np.stack([k.numpy() for k in tmass._edge_metric(tjac, ttb.w)], axis=1)
    return ttb, k_rows, tmass.mass_edge(ttb, tjac).numpy(), np.asarray(jmass.mass_edge(jtb, jjac))


@functools.cache
def _walked(orders, plan):
    """``_walk_plan`` of ``plan`` over the batch of ``orders``."""
    ttb, k_rows, _, _ = _walk_batch(orders)
    return _walk_plan(ttb, plan, k_rows)


@pytest.mark.parametrize("n_elem", WALK_BATCHES)
@pytest.mark.parametrize(
    "orders", [(p, p) for p in range(1, 17)] + [(9, 3), (3, 10)], ids=lambda o: f"{o[0]}-{o[1]}"
)
def test_launch_plan_walk_matches_plain_and_jax(orders, n_elem):
    """The plan the wrapper takes for a batch of E on an H100 (the panel
    route where it leaves the element route), walked in NumPy item by item
    over the table slices, stores each entry of every element's M1 once and
    agrees with the plain version and the JAX package's mass_edge on the
    same corners."""
    ttb, _, plain, jax = _walk_batch(orders)
    n_h, n_v, nq = ttb.bh.shape[0], ttb.bv.shape[0], ttb.w.size
    plan = kernel.launch_plan(n_h, n_v, nq, torch.float64, n_elem, CARD)
    element = kernel.element_plan(n_h, n_v, nq, torch.float64)
    assert plan == element or plan == kernel.panel_plan(
        n_h, n_v, nq, torch.float64, element.mr, element.nc, n_elem, CARD
    )
    out, stored = _walked(orders, plan)
    assert (stored == 1).all()
    assert rel(out[:n_elem], plain[:n_elem]) <= 1e-12
    assert rel(out[:n_elem], jax[:n_elem]) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    cases = [((2, 2), 37), ((4, 4), 37), ((3, 5), 37), ((8, 8), 37), ((9, 9), 37),
             ((10, 10), 37), ((10, 10), 1), ((10, 10), 16), ((16, 16), 1), ((16, 16), 16)]
    for orders, n_elem in cases:
        _, _, ttb, tjac = _shared_geometry(
            orders, _corners(n_elem, seed=4), order_difference=3
        )
        jac = type(tjac)(*(t.to("cuda", dtype) for t in tjac))
        before = kernel.launches
        out = kernel.mass_edge(ttb, jac)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert rel(out.cpu(), tmass.mass_edge(ttb, jac).cpu()) <= tol
