"""The batched inverse of the port against the JAX package.

``gj_inverse`` runs its plain version (``gj_inverse_plain``,
``torch.linalg.inv``) on CPU tensors; the CUDA kernel is held against that
plain version on the card (``cuda``-marked test, and chip_smoke.py).  Here
the plain version is held against ``gj_inverse_pallas`` in interpret mode,
the refinement probe against the JAX one, and the mass inverses of the
element batches against the JAX package's.  Step-by-step mirrors of the
kernel's blocked and streamed routes (:func:`blocked_gj_mirror`) and
register route (:func:`implicit_gj_mirror`) hold their algebra against the
plain version and the Pallas kernel (the streamed route's at n = 460 and
520, at n = 1056 and 1089 with the clustered panel's 32 columns, and on the
Navier-Stokes p=10 and p=16 blocks, the p=10 ones against the JAX
package's blocks and f64 inverse; at odd n also swept, as the kernel
sweeps it, in a work matrix of 16-byte rows with NaN padding), and the
route rule and launch plan (``kernel.launch_plan``, with its row stride)
are checked for every n to 4,096.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfv2d_torch import evaluation as tev
from mfv2d_torch.kform import UnknownFormOrder as TOrder
from mfv2d_torch.ops import precision as tprec
from mfv2d_torch.ops.basis import FemCache as TFemCache
from mfv2d_torch.ops.kernels import gj_inverse as kernel
from mfv2d_tpu import evaluation as jev
from mfv2d_tpu.kform import UnknownFormOrder as JOrder
from mfv2d_tpu.ops import precision as jprec
from mfv2d_tpu.ops.basis import FemCache
from mfv2d_tpu.ops.pallas_factor import gj_inverse_pallas

torch.set_num_threads(1)

BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])


def rel(mine, ref) -> float:
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


def saddle_blocks(e, n_m, n_b, seed, zero_block_first=False):
    """``[[M, B^T], [B, 0]]`` with M SPD and B of full row rank; optionally
    ordered ``[[0, B], [B^T, M]]`` so the leading diagonal entries are zero."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(e, n_m, n_m))
    m = m @ m.transpose(0, 2, 1) + n_m * np.eye(n_m)
    b = rng.normal(size=(e, n_b, n_m))
    z = np.zeros((e, n_b, n_b))
    if zero_block_first:
        return np.block([[z, b], [b.transpose(0, 2, 1), m]])
    return np.block([[m, b.transpose(0, 2, 1)], [b, z]])


def saddle_mix(n, seed):
    """Two n x n saddle blocks in each ordering; n // 3 multiplier rows."""
    n_b = n // 3
    return np.concatenate(
        [saddle_blocks(2, n - n_b, n_b, seed, zero_block_first=z) for z in (True, False)]
    )


def blocked_gj_mirror(
    a: torch.Tensor, b: int, ld: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocked and streamed routes of ``csrc/gj_inverse.cu``, step by
    step, batched.

    Panels of ``b`` columns are swept with partial pivoting (the largest
    |W[i,k]| over rows i >= k, ties to the smaller row, NaN as +inf); every
    other column tile of width ``b`` is gathered through the panel's row
    swaps and updated by the rank-b product with the panel; the row swaps
    are undone as column swaps at the end.  With ``b >= n`` there are no
    tiles and this is the unblocked sweep.  How the streamed route's panel
    launch spreads the panel's rows (registers of one block or of a
    cluster, shared memory, L2) does not change this algebra.  Returns
    the inverses and ``info``: 0, or each matrix's first failing pivot k+1.

    The streamed route reads a row i outside the panel's rows K only from
    its own row or from a row of K; the gather is checked for that here.

    With ``ld`` the matrices are swept, as the streamed route sweeps them,
    in a work matrix of ``ld >= n`` columns whose padding columns hold NaN:
    a column tile that reaches past n reads zeros there (the staging's
    copies stop at n) and may write them.
    """
    e, n, _ = a.shape
    ld = n if ld is None else ld
    batch = torch.arange(e)[:, None]
    w = torch.full((e, n, ld), math.nan, dtype=a.dtype)
    w[:, :, :n] = a
    data = torch.arange(ld) < n  # the columns that hold the matrix
    perm = torch.zeros((e, n), dtype=torch.long)
    info = torch.zeros(e, dtype=torch.long)
    for k0 in range(0, n, b):
        k1 = min(k0 + b, n)
        m = w[:, :, k0:k1].clone()  # the panel
        src = torch.arange(n).repeat(e, 1)  # the row of w that lands in each row
        for k in range(k0, k1):
            t = k - k0
            key = m[:, k:, t].abs().nan_to_num(nan=math.inf, posinf=math.inf)
            first = key.argmax(dim=1)  # the first of equal keys
            best = key.gather(1, first[:, None])[:, 0]
            info = torch.where((info == 0) & ~((best > 0) & (best < math.inf)), k + 1, info)
            p = k + first
            perm[:, k] = p
            swap = torch.arange(n).repeat(e, 1)
            swap[:, k] = p
            swap[batch[:, 0], p] = k
            m = m[batch, swap]
            src = src.gather(1, swap)
            inv_pivot = 1.0 / m[:, k, t]
            row = m[:, k, :] * inv_pivot[:, None]
            row[:, t] = inv_pivot
            col = m[:, :, t].clone()
            m[:, :, t] = 0.0
            m = m - col[:, :, None] * row[:, None, :]
            m[:, k, :] = row
        w[:, :, k0:k1] = m
        outside = torch.ones(n, dtype=torch.bool)
        outside[k0:k1] = False
        rows = torch.arange(n)
        assert torch.all((src == rows) | ((src >= k0) & (src < k1)) | ~outside)
        for j0 in range(0, n, b):
            if j0 != k0:
                tile = torch.where(data[j0 : j0 + b], w[:, :, j0 : j0 + b], 0.0)[batch, src]
                pivot_rows = tile[:, k0:k1].clone()
                tile[:, k0:k1] = 0.0
                w[:, :, j0 : j0 + b] = tile + m @ pivot_rows
    cols = torch.arange(n).repeat(e, 1)  # the column of w that lands in each column
    for k in reversed(range(n)):
        pk = perm[:, k]
        c_k = cols[:, k].clone()
        cols[:, k] = cols[batch[:, 0], pk]
        cols[batch[:, 0], pk] = c_k
    return w[:, :, :n].gather(2, cols[:, None, :].expand(e, n, n)), info


def implicit_gj_mirror(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The register route of ``csrc/gj_inverse.cu``, step by step, batched.

    Implicit pivoting: no row is ever swapped.  Step k picks the pivot p_k,
    the largest |T[i,k]| over the rows not yet used (ties to the smaller
    original row, NaN as +inf), and sweeps in place: the pivot row becomes
    ``T[p,:] / piv`` with ``T[p,k] = 1 / piv``, every other row i becomes
    ``T[i,:] - T[i,k] row`` with ``T[i,k]`` taken as 0.  At the end
    ``inverse[k, p_j] = T[p_k, j]``.

    As in the kernel, each row lives in a register array of n rounded up
    to 8 entries, zero-padded past n, and is rotated
    left one place per step so that column k always sits at index 0; the
    new column-k value goes to the last index.  After n steps column j sits
    at index ``length - n + j``.  The pivot row is scaled lazily: its
    owner keeps its raw row (``T[p,:] = s_p u_p`` with ``s_p = 1 / piv``,
    applied once at the end) and broadcasts it unscaled; every other row
    takes ``f_i = u_i[0] / piv`` and subtracts ``f_i`` times it, with ``-f_i``
    in the last place.  Returns the inverses and ``info``: 0, or each
    matrix's first failing pivot k+1.
    """
    e, n, _ = a.shape
    cap = -(-n // 8) * 8
    batch = torch.arange(e)
    u = torch.zeros((e, n, cap), dtype=a.dtype)
    u[:, :, :n] = a
    used = torch.zeros((e, n), dtype=torch.bool)
    scale = torch.ones((e, n), dtype=a.dtype)
    perm = torch.zeros((e, n), dtype=torch.long)
    info = torch.zeros(e, dtype=torch.long)
    for k in range(n):
        key = u[:, :, 0].abs().nan_to_num(nan=math.inf, posinf=math.inf)
        key = torch.where(used, -1.0, key)
        p = key.argmax(dim=1)  # the first of equal keys: the smaller row
        best = key[batch, p]
        info = torch.where((info == 0) & ~((best > 0) & (best < math.inf)), k + 1, info)
        perm[:, k] = p
        raw = u[batch, p]
        inv_pivot = 1.0 / raw[:, 0]
        f = u[:, :, 0] * inv_pivot[:, None]
        f[batch, p] = 0.0
        b = torch.cat([raw[:, 1:], torch.ones_like(raw[:, :1])], dim=1)
        shifted = torch.cat([u[:, :, 1:], torch.zeros_like(u[:, :, :1])], dim=2)
        u = shifted - f[:, :, None] * b[:, None, :]
        u[batch, p, -1] = 1.0
        scale[batch, p] = inv_pivot
        used[batch, p] = True
    t = u[:, :, cap - n :] * scale[:, :, None]  # t[i, j] = T[i, j]
    inv = torch.empty_like(a)
    inv[batch[:, None, None], torch.arange(n)[None, :, None], perm[:, None, :]] = t[
        batch[:, None], perm
    ]
    return inv, info


@pytest.mark.parametrize("n", [1, 5, 16, 32, 33, 56, 64])
def test_implicit_mirror_matches_plain(n):
    """Saddle blocks with the zero block first and last, at and around the
    route's two capacities."""
    a = torch.tensor(saddle_mix(n, seed=n))
    if n > 2:
        assert torch.all(a[:2, : n // 3, : n // 3] == 0.0)
        assert torch.all(a[2:, n - n // 3 :, n - n // 3 :] == 0.0)
    inv, info = implicit_gj_mirror(a)
    assert torch.all(info == 0)
    assert rel(inv, tprec.gj_inverse_plain(a).numpy()) <= 1e-12


def test_implicit_mirror_reports_the_same_failing_pivot():
    a = torch.tensor(np.concatenate([saddle_mix(56, seed=8)] * 2))
    a[5, :, 17] = 0.0
    _, info = implicit_gj_mirror(a)
    _, blocked_info = blocked_gj_mirror(a, 32)
    assert torch.equal(info, blocked_info)
    assert info.tolist() == [0] * 5 + [18] + [0] * 2


def test_implicit_mirror_matches_gj_inverse_pallas():
    """As test_blocked_mirror_matches_gj_inverse_pallas, for the register
    route's algebra, f32."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(8, 64, 64)) + 64 * np.eye(64)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(gj_inverse_pallas(jnp.asarray(a), tile=4))
    mine, info = implicit_gj_mirror(torch.tensor(a))
    assert mine.dtype == torch.float32 and torch.all(info == 0)
    assert rel(mine, ref) <= 5e-5


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("n", [1, 5, 33, 64, 97, 170])
def test_blocked_mirror_matches_plain(n, b):
    """Ragged last panels, and saddle blocks whose zero block comes first."""
    a = torch.tensor(saddle_mix(n, seed=n))
    if n > 1:
        assert torch.all(a[:2, : n // 3, : n // 3] == 0.0)
    inv, info = blocked_gj_mirror(a, b)
    assert torch.all(info == 0)
    assert rel(inv, tprec.gj_inverse_plain(a).numpy()) <= 1e-12


@pytest.mark.parametrize("b", [8, 32])
def test_blocked_mirror_reports_the_unblocked_failing_pivot(b):
    a = torch.tensor(np.concatenate([saddle_mix(97, seed=8)] * 2))
    a[5, :, 17] = 0.0
    _, info = blocked_gj_mirror(a, b)
    _, unblocked_info = blocked_gj_mirror(a, a.shape[1])
    assert torch.equal(info, unblocked_info)
    assert info.tolist() == [0] * 5 + [18] + [0] * 2


@pytest.mark.parametrize(
    "n, b",
    [(219, 32), (440, 32), (441, 32), (460, 32), (460, 16), (520, 16), (1056, 32), (1089, 32)],
)
def test_streamed_mirror_matches_plain(n, b):
    """The streamed route's sizes: its first n in f64 (219), the first
    above the blocked route's old cap (440), the phase-10 blocks' n (441)
    and n=460, at the route's panel width and at the narrower width it
    takes above n=512; and the clustered panel's n=1056 and 1089 (the p=16
    Navier-Stokes blocks), at its 32 columns."""
    assert b in (kernel.launch_plan(n, torch.float64).panel, 16)
    a = torch.tensor(saddle_mix(n, seed=n))
    assert torch.all(a[:2, : n // 3, : n // 3] == 0.0)
    inv, info = blocked_gj_mirror(a, b)
    assert torch.all(info == 0)
    assert rel(inv, tprec.gj_inverse_plain(a).numpy()) <= 1e-10


@pytest.mark.parametrize("n", [219, 289, 441, 1089])
def test_streamed_mirror_on_padded_rows_is_bitwise_the_compact_one(n):
    """The streamed route's odd n (its first, config 3's blocks, the
    Navier-Stokes p=10 and p=16 blocks) swept at the plan's row stride,
    with NaN in the padding columns: no NaN reaches the result, which is
    bitwise the compact sweep's."""
    plan = kernel.launch_plan(n, torch.float64)
    assert plan.ld == n + 1
    a = torch.tensor(saddle_mix(n, seed=n))[: 2 if n > 1000 else 4]
    inv, info = blocked_gj_mirror(a, plan.panel)
    padded, padded_info = blocked_gj_mirror(a, plan.panel, plan.ld)
    assert torch.all(info == 0) and torch.equal(padded_info, info)
    assert torch.equal(padded, inv)
    assert rel(inv, tprec.gj_inverse_plain(a).numpy()) <= 1e-10


def navier_stokes_blocks(mesh_n: int = 4, p: int = 10) -> torch.Tensor:
    """The element blocks of Navier-Stokes Re=10 on a mesh_n x mesh_n mesh
    at order p (n = (2p + 1)^2: 441 at p=10), assembled by the port on the
    CPU."""
    import mfv2d_torch as mf
    from mfv2d_torch.compiler import CompiledSystem
    from mfv2d_torch.models import flow
    from mfv2d_torch.solver.discretization import discretize_mesh
    from mfv2d_torch.solver.solve import SystemEvaluator

    system = flow.navier_stokes(10.0).system
    compiled = CompiledSystem(system)
    mesh = mf.examples.unit_square_mesh(mesh_n, mesh_n, p)
    disc = discretize_mesh(mesh, system.unknown_forms, TFemCache(3), device="cpu")
    evaluator = SystemEvaluator(disc.form_spec, compiled, disc)
    return torch.as_tensor(evaluator.element_matrices(compiled.lhs_blocks)[0])


def navier_stokes_p10_blocks_jax() -> np.ndarray:
    """The same blocks, assembled by the JAX package."""
    import mfv2d_tpu as jmf
    from mfv2d_tpu.compiler import CompiledSystem
    from mfv2d_tpu.models import flow
    from mfv2d_tpu.solver.discretization import discretize_mesh
    from mfv2d_tpu.solver.solve import SystemEvaluator

    system = flow.navier_stokes(10.0).system
    compiled = CompiledSystem(system)
    mesh = jmf.examples.unit_square_mesh(4, 4, 10)
    disc = discretize_mesh(mesh, system.unknown_forms, FemCache(3))
    evaluator = SystemEvaluator(system.unknown_forms, compiled, disc)
    return np.asarray(evaluator.element_matrices(compiled.lhs_blocks)[0])


def test_streamed_mirror_inverts_navier_stokes_p10_blocks():
    """The port's blocks against the JAX package's, and the mirror's
    inverse of them against the JAX package's f64 inverse
    (``newton_schulz_inverse``) and the plain version."""
    a = navier_stokes_blocks()
    assert a.shape == (16, 441, 441) and a.dtype == torch.float64
    ref_blocks = navier_stokes_p10_blocks_jax()
    assert rel(a, ref_blocks) <= 1e-12
    assert kernel.route(441, torch.float64) == "streamed"
    inv, info = blocked_gj_mirror(a, kernel.launch_plan(441, torch.float64).panel)
    assert torch.all(info == 0)
    ref, _ = jprec.newton_schulz_inverse(jnp.asarray(ref_blocks))
    assert rel(inv, np.asarray(ref)) <= 1e-10
    assert rel(inv, tprec.gj_inverse_plain(a).numpy()) <= 1e-10


def test_streamed_mirror_inverts_navier_stokes_p16_blocks():
    """The port's Navier-Stokes blocks at p=16 on a 1x1 mesh (n = 289 +
    544 + 256 = 1089, the first model size past one block's panel), through
    the mirror at the width of the plan's clustered panel, against the
    plain version."""
    a = navier_stokes_blocks(1, 16)
    assert a.shape == (1, 1089, 1089) and a.dtype == torch.float64
    plan = kernel.launch_plan(1089, torch.float64)
    assert plan.route == "streamed" and plan.blocks > 1
    inv, info = blocked_gj_mirror(a, plan.panel)
    assert torch.all(info == 0)
    assert rel(inv, tprec.gj_inverse_plain(a).numpy()) <= 1e-10


@pytest.mark.parametrize("b", [32, 16])
def test_streamed_mirror_reports_the_failing_pivot(b):
    a = torch.tensor(np.concatenate([saddle_mix(460, seed=8)] * 2))
    a[5, :, 17] = 0.0
    _, info = blocked_gj_mirror(a, b)
    assert info.tolist() == [0] * 5 + [18] + [0] * 2


def panel_static_bytes(panel: int, blocks: int, size: int) -> int:
    """The panel kernel's static arrays (streamed_panel_static in
    csrc/gj_inverse.cu): one block's pivot row, row k, 8 warp maxima and
    its maximum (keys and rows), or a cluster's two sets of a candidate row
    for each of its 8 block slots, row k, 8 warp maxima and 8 block
    maxima."""
    if blocks == 1:
        return 2 * panel * size + 9 * (size + 4)
    return 2 * (9 * panel * size + 16 * (size + 4))


def test_route_rule_covers_every_n():
    """Each n from 1 to 4,096 takes one route, the routes follow one another
    in the order register, blocked, streamed, every n from 219 on takes the
    streamed route, and its launch plan fits the kernel: at most 64 panel
    entries a thread in registers, at most 8 panel blocks a matrix (one
    cluster), every panel row held by one block, and each launch's shared
    memory (as csrc/gj_inverse.cu computes it) within what a block may use."""
    for dtype in (torch.float64, torch.float32):
        size = 8 if dtype == torch.float64 else 4
        taken = []
        for n in range(1, 4097):
            plan = kernel.launch_plan(n, dtype)
            taken.append(plan.route)
            assert kernel.route(n, dtype) == plan.route
            if plan.route == "register":
                assert n <= kernel.REGISTER_MAX_N
            if plan.route == "blocked":
                assert kernel.REGISTER_MAX_N < n <= kernel.BLOCKED_MAX_N
            if n > kernel.BLOCKED_MAX_N:
                assert plan.route == "streamed"
                rows = kernel.PANEL_ROWS[plan.panel]
                assert rows * plan.panel <= 64
                assert (plan.panel, plan.blocks) == (
                    (32, 1) if n <= 512 else (16, 1) if n <= 1024 else (32, -(-n // 512))
                )
                held = plan.blocks * rows * kernel.THREADS
                assert plan.spill == max(0, -(-(n - held) // plan.blocks)) == 0
                # streamed_panel_bytes and the panel kernel's static arrays,
                # streamed_update_bytes, streamed_unswap_bytes
                src = -(-4 * n // 16) * 16
                static = panel_static_bytes(plan.panel, plan.blocks, size)
                assert plan.panel_bytes == src + static <= kernel.SMEM_LIMIT
                ld = plan.panel + 4
                update = (2 * plan.panel * ld + 3 * 2 * 32 * ld) * size + 4 * n
                assert plan.update_bytes == update <= kernel.SMEM_LIMIT
                assert plan.unswap_warps == 4
                assert src + 4 * n * size <= kernel.SMEM_LIMIT
        order = [kernel.ROUTES.index(r) for r in taken]
        assert order == sorted(order)
        assert all(r == "register" for r in taken[:64])
    # Two f64 blocked blocks fit on an SM (228 KB, 1 KB kept per block)
    # up to BLOCKED_MAX_N; the ablation's boundary: blocked at 208,
    # streamed from 224.
    def blocked_bytes(n):  # blocked_route_bytes in csrc/gj_inverse.cu, f64
        return (n * 33 + n * 32 + 2 * 32 + 8) * 8 + (8 + 2 * n) * 4

    assert [2 * (blocked_bytes(n) + 1024) <= 233472 for n in (218, 219)] == [True, False]
    assert kernel.route(208, torch.float64) == "blocked"
    assert kernel.route(121, torch.float64) == "blocked"
    assert kernel.launch_plan(1089, torch.float64)[:4] == ("streamed", 32, 3, 0)
    assert kernel.launch_plan(2401, torch.float64)[:4] == ("streamed", 32, 5, 0)
    with pytest.raises(ValueError):
        kernel.route(0, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launch_plan_rows_are_16_bytes_apart(dtype):
    """Every streamed n to 4,096 sweeps a work matrix whose rows start 16
    bytes apart: ld >= n, ld rounds n up to 16 bytes (n itself where n x
    size already is one, n + 1 for odd n in f64), and the extra device
    memory is E n (ld - n) entries.  The stride moves nothing of the plan's
    shared memory, so every launch still fits and the route still ends at
    n = 19,370 in f64."""
    size = 8 if dtype == torch.float64 else 4
    vec = 16 // size
    for n in range(1, 4097):
        plan = kernel.launch_plan(n, dtype)
        if plan.route != "streamed":
            assert plan.ld == 0
            continue
        assert plan.ld * size % 16 == 0 and n <= plan.ld < n + vec
        assert (plan.ld == n) == (n * size % 16 == 0)
        if dtype == torch.float64:
            assert plan.ld == n + n % 2
        src = -(-4 * n // 16) * 16
        assert plan.panel_bytes == src + panel_static_bytes(plan.panel, plan.blocks, size)
        assert plan.update_bytes == (2 * plan.panel + 3 * 2 * 32) * (plan.panel + 4) * size + 4 * n
        assert max(plan.panel_bytes, plan.update_bytes) <= kernel.SMEM_LIMIT
        assert src + plan.unswap_warps * n * size <= kernel.SMEM_LIMIT
    assert kernel.launch_plan(289, dtype).ld == (290 if size == 8 else 292)
    assert kernel.launch_plan(1089, dtype).ld == (1090 if size == 8 else 1092)
    if dtype == torch.float64:
        assert kernel.launch_plan(19370, dtype).ld == 19370
        with pytest.raises(ValueError, match="shared memory"):
            kernel.launch_plan(19371, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_launch_plan_spills_past_the_cluster(dtype):
    """Above n = 4,096 a cluster of eight blocks holds 4,096 panel rows in
    registers and each block keeps its share of the rest in L2, so the
    panel launch's shared memory stays the row gather and the step's
    arrays; the layout holds n until one row of the column swaps and the
    row permutation no longer fit in shared memory (the route's name stays
    "streamed" beyond)."""
    size = 8 if dtype == torch.float64 else 4
    last = kernel.SMEM_LIMIT // (4 + size)
    while -(-4 * last // 16) * 16 + last * size > kernel.SMEM_LIMIT:
        last -= 1
    for n in (4097, 5000, 6000, 9000, 12000, last):
        plan = kernel.launch_plan(n, dtype)
        assert (plan.route, plan.panel, plan.blocks) == ("streamed", 32, 8)
        assert 4096 + 8 * plan.spill >= n > 4096 + 8 * (plan.spill - 1)
        src = -(-4 * n // 16) * 16
        assert plan.panel_bytes == src + panel_static_bytes(32, 8, size) <= kernel.SMEM_LIMIT
    assert kernel.launch_plan(4097, dtype).spill == 1
    assert kernel.launch_plan(5000, dtype).spill == 113
    assert kernel.launch_plan(last, dtype).unswap_warps == 1
    with pytest.raises(ValueError, match="shared memory"):
        kernel.launch_plan(last + 1, dtype)
    assert kernel.route(last + 1, dtype) == kernel.route(10**6, dtype) == "streamed"


def test_blocked_mirror_matches_gj_inverse_pallas():
    """The single-level case of test_plain_matches_gj_inverse_pallas, f32."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(8, 64, 64)) + 64 * np.eye(64)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(gj_inverse_pallas(jnp.asarray(a), tile=4))
    mine, info = blocked_gj_mirror(torch.tensor(a), 32)
    assert mine.dtype == torch.float32 and torch.all(info == 0)
    assert rel(mine, ref) <= 5e-5


@functools.cache
def pallas_streamed_case(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Four f32 matrices of size n and their inverses by gj_inverse_pallas
    (interpret mode); the TPU kernel pads n to 512 or 640 and takes two
    levels."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(4, n, n)) + n * np.eye(n)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(gj_inverse_pallas(jnp.asarray(a), tile=4))
    return a, ref


@pytest.mark.parametrize("n, b", [(460, 32), (520, 16)])
def test_streamed_mirror_matches_gj_inverse_pallas(n, b):
    """test_blocked_mirror_matches_gj_inverse_pallas at streamed sizes, at
    both panel widths."""
    assert b == kernel.launch_plan(n, torch.float32).panel
    a, ref = pallas_streamed_case(n)
    mine, info = blocked_gj_mirror(torch.tensor(a), b)
    assert mine.dtype == torch.float32 and torch.all(info == 0)
    assert rel(mine, ref) <= 5e-5


@pytest.mark.parametrize("n, b", [(460, 32), (520, 16)])
def test_padded_streamed_mirror_matches_gj_inverse_pallas(n, b):
    """test_streamed_mirror_matches_gj_inverse_pallas swept in a work
    matrix of 16-byte rows with 4 more columns (NaN) than n, so that the
    last column tile reaches into the padding."""
    ld = n + 4
    assert ld * 4 % 16 == 0 and b == kernel.launch_plan(n, torch.float32).panel
    a, ref = pallas_streamed_case(n)
    mine, info = blocked_gj_mirror(torch.tensor(a), b, ld)
    assert mine.dtype == torch.float32 and torch.all(info == 0)
    assert rel(mine, ref) <= 5e-5


@pytest.mark.parametrize(
    "e, n, kw",
    [(8, 64, {}), (8, 289, {}), (4, 128, {"pivot_block": 128})],
    ids=["single-level", "padded-two-level", "masked-at-block"],
)
def test_plain_matches_gj_inverse_pallas(e, n, kw):
    """The cases of tests/test_pallas.py, in f32 as the TPU kernel runs."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(e, n, n)) + n * np.eye(n)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(gj_inverse_pallas(jnp.asarray(a), tile=4, **kw))
    mine = tprec.gj_inverse_plain(torch.tensor(a))
    assert mine.dtype == torch.float32
    assert rel(mine, ref) <= 5e-5


@pytest.mark.parametrize("zero_block_first", [False, True])
def test_plain_inverts_saddle_blocks(zero_block_first):
    a = saddle_blocks(6, 12, 5, seed=1, zero_block_first=zero_block_first)
    if zero_block_first:
        assert np.all(a[:, :5, :5] == 0.0)
    mine = kernel.gj_inverse(torch.tensor(a))
    assert rel(mine, np.linalg.inv(a)) <= 1e-12


@pytest.mark.parametrize("zero_block_first", [False, True])
def test_choose_refine_rounds_matches_jax(zero_block_first):
    a = saddle_blocks(6, 12, 5, seed=2, zero_block_first=zero_block_first)
    inv = np.linalg.inv(a)
    # An inverse perturbed to need refinement, besides the exact one.
    rough = inv * (1.0 + 1e-7 * np.random.default_rng(0).normal(size=inv.shape))
    for x in (inv, rough):
        jr, jerr = jprec.choose_refine_rounds(jnp.asarray(a), jnp.asarray(x))
        tr, terr = tprec.choose_refine_rounds(torch.tensor(a), torch.tensor(x))
        assert tr == jr
        assert max(terr, jerr) <= 1e-10  # both met the probe's target
    assert tprec.choose_refine_rounds(torch.tensor(a), torch.tensor(rough))[0] > 0


@pytest.mark.parametrize("orders", [(3, 3), (4, 2)])
def test_mass_inverse_matches_jax(orders):
    rng = np.random.default_rng(5)
    corners = np.tile(BASE, (7, 1, 1)) + 0.08 * rng.normal(size=(7, 4, 2))
    jbatch = jev.ElementBatch(FemCache(2).get_basis2d(*orders), corners)
    tbatch = tev.ElementBatch(TFemCache(2).get_basis2d(*orders), corners, "cpu")
    for k in (0, 1, 2):
        mass = np.asarray(jbatch.mass(JOrder(k + 1), False))
        ref = np.asarray(jev._mass_inverse(jnp.asarray(mass)))
        mine = tev._mass_inverse(torch.tensor(mass))
        assert rel(mine, ref) <= 1e-12, k
        assert rel(tbatch.mass(TOrder(k + 1), True), ref) <= 1e-10, k


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.tensor(saddle_blocks(3, 4, 2, seed=4))
    with pytest.raises(TypeError, match="float32 or float64"):
        kernel.gj_inverse(a.to(torch.float16))
    with pytest.raises(TypeError, match="tensor"):
        kernel.gj_inverse(a.numpy())
    with pytest.raises(ValueError, match=r"\[E, n, n\]"):
        kernel.gj_inverse(a[0])
    with pytest.raises(ValueError, match=r"\[E, n, n\]"):
        kernel.gj_inverse(a[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gj_inverse(a.transpose(1, 2))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernel.gj_inverse(a.to("meta"))
    singular = a.clone()
    singular[1] = 0.0
    with pytest.raises(torch.linalg.LinAlgError):
        kernel.gj_inverse(singular)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    a = torch.tensor(saddle_blocks(5, 10, 3, seed=6))
    before = kernel.launches
    assert torch.equal(kernel.gj_inverse(a), tprec.gj_inverse_plain(a))
    batch = tev.ElementBatch(TFemCache(2).get_basis2d(3, 3), BASE[None], "cpu")
    batch.mass(TOrder.FORM_ORDER_1, True)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    f64 = dtype == torch.float64
    routes = {
        1: "register",
        16: "register",
        32: "register",
        33: "register",
        56: "register",
        64: "register",
        65: "blocked",
        121: "blocked",
        170: "blocked",
        208: "blocked",
        289: "streamed",
        441: "streamed",
        460: "streamed",
        625: "streamed",
        1024: "streamed",
        1056: "streamed",
        1089: "streamed",
        3585: "streamed",
        4096: "streamed",
        4097: "streamed",
        5000: "streamed",
    }
    for n, route in routes.items():
        n_b = n // 3
        e = 37 if n <= 1089 else 1  # past n = 3,584 a cluster of 8, past 4,096 rows in L2
        a = torch.tensor(saddle_blocks(e, n - n_b, n_b, seed=n), device="cuda")
        a = a.to(dtype)
        assert kernel.route(n, dtype) == route
        before = kernel.launches
        out = kernel.gj_inverse(a)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert rel(out.cpu(), tprec.gj_inverse_plain(a).cpu().numpy()) <= tol, n
    singular = torch.zeros((2, 5, 5), dtype=dtype, device="cuda")
    with pytest.raises(torch.linalg.LinAlgError, match="matrix 0"):
        kernel.gj_inverse(singular)
    # n = 460 (streamed), 208 (blocked) and 56 (register)
    for n_m, n_b in ((307, 153), (139, 69), (38, 18)):
        singular = torch.tensor(saddle_blocks(8, n_m, n_b, seed=9), device="cuda").to(dtype)
        singular[5, :, 17] = 0.0
        with pytest.raises(torch.linalg.LinAlgError, match="matrix 5 .* pivot 18 "):
            kernel.gj_inverse(singular)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_at_odd_n_matches_plain_on_card(dtype):
    """The streamed route at odd n, where its work matrix is padded to
    16-byte rows, and at the even n beside them, at an odd E (the odd
    input matrices of an odd n start 8 bytes off 16); the rows reversed,
    so that every panel swaps rows; a singular matrix at odd n."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    for n in (219, 289, 290, 1025, 1089, 1090):
        n_b = n // 3
        a = torch.tensor(saddle_blocks(5, n - n_b, n_b, seed=n), device="cuda").to(dtype)
        assert kernel.route(n, dtype) == "streamed"
        for x in (a, a.flip(1).contiguous()):
            out = kernel.gj_inverse(x)
            torch.cuda.synchronize()
            assert rel(out.cpu(), tprec.gj_inverse_plain(x).cpu().numpy()) <= tol, n
        if n % 2:
            singular = a.clone()
            singular[3, :, 17] = 0.0
            with pytest.raises(torch.linalg.LinAlgError, match="matrix 3 .* pivot 18 "):
                kernel.gj_inverse(singular)
