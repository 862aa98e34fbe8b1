"""L2 projections (dual/primal DoFs) and point reconstruction of forms.

``element_dual_dofs_batched`` and ``element_primal_dofs`` work on an
:class:`ElementBatch` on its device.  The rest runs in NumPy on the host:
the forcing projections evaluate host callables, and the reconstructions
feed the host output grids and the refinement estimators.
``reconstruct`` works on one element at arbitrary reference points,
``reconstruct_batched`` on a whole bucket.  Semantics follow the reference
(python/mfv2d/mimetic2d.py:1003-1279).
"""

from __future__ import annotations

import numpy as np
import numpy.typing as npt
import torch

from mfv2d_torch.evaluation import ElementBatch, apply_mass
from mfv2d_torch.kform import UnknownFormOrder
from mfv2d_torch.ops.basis import Basis2D
from mfv2d_torch.ops.quadrature import dlagrange1d, lagrange1d
from mfv2d_torch.system import ElementFormSpecification
from mfv2d_torch.transfer import to_device


def evaluate_function_on_batch(batch: ElementBatch, function) -> np.ndarray:
    """Host-evaluate a user callable at the batch's quadrature points.

    The bilinear map runs in NumPy: the values feed a host callable.
    """
    corners = batch.corners_np
    tb = batch.tb
    xi = np.broadcast_to(
        tb.nodes_xi[None, :], (tb.nodes_eta.size, tb.nodes_xi.size)
    )
    eta = np.broadcast_to(tb.nodes_eta[:, None], xi.shape)
    shapes = np.stack(
        [
            (1 - xi) * (1 - eta),
            (1 + xi) * (1 - eta),
            (1 + xi) * (1 + eta),
            (1 - xi) * (1 + eta),
        ]
    ).reshape(4, -1) / 4
    x = corners[:, :, 0] @ shapes
    y = corners[:, :, 1] @ shapes
    return np.asarray(function(x, y), np.float64)


def element_dual_dofs_batched(
    order: UnknownFormOrder, batch: ElementBatch, values
) -> torch.Tensor:
    """Dual DoFs (L2 functional values) of a function over the batch.

    ``values`` are the function values at the quadrature points: shape
    ``[E, nq]`` for 0/2-forms, ``[E, nq, 2]`` (physical x, y components) for
    1-forms.  Returns ``[E, n_dofs]`` on the batch's device.

    The counterpart of the JAX package's public function of that name; no
    path of the port calls it (the solvers project host callables with
    :func:`element_dual_dofs`).
    """
    tb = batch.tb
    jac = batch.jac
    vals = to_device(values, jac.det.device, jac.det.dtype)
    w = tb.tensor("w", jac.det)
    if order == UnknownFormOrder.FORM_ORDER_0:
        return (vals * w * jac.det) @ tb.tensor("b0", jac.det).T
    if order == UnknownFormOrder.FORM_ORDER_1:
        f_xi = (jac.j00 * vals[..., 0] + jac.j01 * vals[..., 1]) * w
        f_eta = (jac.j10 * vals[..., 0] + jac.j11 * vals[..., 1]) * w
        d_h = f_eta @ tb.tensor("bh", f_eta).T
        d_v = f_xi @ tb.tensor("bv", f_xi).T
        return torch.cat([d_h, d_v], dim=1)
    if order == UnknownFormOrder.FORM_ORDER_2:
        return (vals * w) @ tb.tensor("b2", jac.det).T
    raise ValueError(f"Invalid form order {order}.")


def element_dual_dofs(
    order: UnknownFormOrder, batch: ElementBatch, function
) -> np.ndarray:
    """Dual DoFs of a host-evaluated callable over the batch (NumPy).

    The function values come from a host callable and the result feeds the
    host-side RHS/IC assembly, so the whole projection runs in NumPy.
    """
    vals = evaluate_function_on_batch(batch, function)
    e, nq = batch.n_elements, batch.n_quad
    tb = batch.tb
    corners = batch.corners_np
    xi = tb.nodes_xi[None, :]
    eta = tb.nodes_eta[:, None]
    if order == UnknownFormOrder.FORM_ORDER_0:
        det = _jacobian_np(corners, xi, eta)[4].reshape(e, nq)
        k = vals.reshape(e, nq) * tb.w * det
        return k @ tb.b0.T
    if order == UnknownFormOrder.FORM_ORDER_1:
        vals = vals.reshape(e, nq, 2)
        j00, j01, j10, j11, _ = (
            j.reshape(e, nq) for j in _jacobian_np(corners, xi, eta)
        )
        f_xi = (j00 * vals[..., 0] + j01 * vals[..., 1]) * tb.w
        f_eta = (j10 * vals[..., 0] + j11 * vals[..., 1]) * tb.w
        return np.concatenate([f_eta @ tb.bh.T, f_xi @ tb.bv.T], axis=1)
    if order == UnknownFormOrder.FORM_ORDER_2:
        k = vals.reshape(e, nq) * tb.w
        return k @ tb.b2.T
    raise ValueError(f"Invalid form order {order}.")


def element_primal_dofs(
    order: UnknownFormOrder, batch: ElementBatch, function
) -> torch.Tensor:
    """Primal DoFs of a host callable over the batch: the inverse mass of
    its order applied to its dual DoFs, on the batch's device.

    The counterpart of the JAX package's public function of that name; no
    path of the port calls it.
    """
    dual = element_dual_dofs(order, batch, function)
    spec = ElementFormSpecification(("_primal", int(order)))
    return apply_mass(
        spec, batch, to_device(dual, batch.device), inverse=True
    )


def reconstruct(
    corners: npt.ArrayLike,
    basis: Basis2D,
    form_order: UnknownFormOrder,
    dofs: npt.ArrayLike,
    xi: npt.ArrayLike,
    eta: npt.ArrayLike,
) -> np.ndarray:
    """Point values of a k-form from its primal DoFs (host, one element).

    For 1-forms the physical components include the Piola map
    ``J^T (out_xi, out_eta) / det``; 2-forms carry ``1/det``
    (mimetic2d.py:1172-1279).
    """
    form_order = UnknownFormOrder(form_order)
    c = np.asarray(dofs, np.float64)
    corners = np.asarray(corners, np.float64)
    p1 = basis.basis_xi.order
    p2 = basis.basis_eta.order
    xi = np.asarray(xi, np.float64)
    eta = np.asarray(eta, np.float64)
    grid_shape = np.broadcast(xi, eta).shape

    if form_order == UnknownFormOrder.FORM_ORDER_0:
        vx = lagrange1d(basis.basis_xi.roots, xi)  # xi.shape + (p1+1,)
        ve = lagrange1d(basis.basis_eta.roots, eta)
        out = np.zeros(grid_shape, np.float64)
        for i2 in range(p2 + 1):
            for i1 in range(p1 + 1):
                out = out + c[i2 * (p1 + 1) + i1] * (vx[..., i1] * ve[..., i2])
        return out

    # Jacobian entries with plain scalar-corner broadcasting: supports both
    # tensor grids and paired point lists (xi[i], eta[i]), matching the
    # reference reconstruct semantics (mimetic2d.py:876-950).
    (x0, y0), (x1, y1), (x2, y2), (x3, y3) = corners
    j00 = ((x1 - x0) * (1 - eta) + (x2 - x3) * (1 + eta)) / 4
    j01 = ((y1 - y0) * (1 - eta) + (y2 - y3) * (1 + eta)) / 4
    j10 = ((x3 - x0) * (1 - xi) + (x2 - x1) * (1 + xi)) / 4
    j11 = ((y3 - y0) * (1 - xi) + (y2 - y1) * (1 + xi)) / 4
    det = j00 * j11 - j10 * j01
    j00, j01, j10, j11, det = (
        np.broadcast_to(v, grid_shape) for v in (j00, j01, j10, j11, det)
    )

    ex = -np.cumsum(dlagrange1d(basis.basis_xi.roots, xi)[..., :-1], axis=-1)
    ee = -np.cumsum(dlagrange1d(basis.basis_eta.roots, eta)[..., :-1], axis=-1)

    if form_order == UnknownFormOrder.FORM_ORDER_1:
        vx = lagrange1d(basis.basis_xi.roots, xi)
        ve = lagrange1d(basis.basis_eta.roots, eta)
        out_eta = np.zeros(grid_shape, np.float64)
        out_xi = np.zeros(grid_shape, np.float64)
        for i2 in range(p2 + 1):
            for i1 in range(p1):
                out_eta = out_eta + c[i2 * p1 + i1] * ex[..., i1] * ve[..., i2]
        n_h = p1 * (p2 + 1)
        for i2 in range(p2):
            for i1 in range(p1 + 1):
                out_xi = out_xi + c[n_h + i2 * (p1 + 1) + i1] * vx[..., i1] * ee[..., i2]
        return np.stack(
            (
                (out_xi * j00 + out_eta * j10) / det,
                (out_xi * j01 + out_eta * j11) / det,
            ),
            axis=-1,
        )

    if form_order == UnknownFormOrder.FORM_ORDER_2:
        out = np.zeros(grid_shape, np.float64)
        for i2 in range(p2):
            for i1 in range(p1):
                out = out + c[i2 * p1 + i1] * ex[..., i1] * ee[..., i2]
        return out / det

    raise ValueError(f"Order of the differential form {form_order} is not valid.")


def _jacobian_np(corners, xi, eta):
    """Pure-NumPy Jacobian terms for the host paths."""
    c = np.asarray(corners, np.float64)
    t0 = np.asarray(xi, np.float64)
    t1 = np.asarray(eta, np.float64)
    single = c.ndim == 2
    if single:
        c = c[None]
    x = c[..., 0][..., None, None]
    y = c[..., 1][..., None, None]
    x0, x1, x2, x3 = (x[:, i] for i in range(4))
    y0, y1, y2, y3 = (y[:, i] for i in range(4))
    j00 = ((x1 - x0) * (1 - t1) + (x2 - x3) * (1 + t1)) / 4
    j01 = ((y1 - y0) * (1 - t1) + (y2 - y3) * (1 + t1)) / 4
    j10 = ((x3 - x0) * (1 - t0) + (x2 - x1) * (1 + t0)) / 4
    j11 = ((y3 - y0) * (1 - t0) + (y2 - y1) * (1 + t0)) / 4
    det = j00 * j11 - j10 * j01
    shape = det.shape
    out = tuple(np.broadcast_to(v, shape) for v in (j00, j01, j10, j11, det))
    if single:
        out = tuple(v[0] for v in out)
    return out


def _physical_coordinates_np(corners, xi, eta):
    """Pure-NumPy bilinear map for the host paths.

    ``corners`` is ``[E, 4, 2]`` (or ``[4, 2]``); returns (x, y) broadcast
    over the reference grid.
    """
    c = np.asarray(corners, np.float64)
    t0 = np.asarray(xi, np.float64)
    t1 = np.asarray(eta, np.float64)
    single = c.ndim == 2
    if single:
        c = c[None]
    t0, t1 = np.broadcast_arrays(t0, t1)
    shapes = np.stack(
        [
            (1 - t0) * (1 - t1),
            (1 + t0) * (1 - t1),
            (1 + t0) * (1 + t1),
            (1 - t0) * (1 + t1),
        ]
    ) / 4  # [4, *grid]
    x = np.tensordot(c[:, :, 0], shapes, axes=(1, 0))  # [E, *grid]
    y = np.tensordot(c[:, :, 1], shapes, axes=(1, 0))
    if single:
        x, y = x[0], y[0]
    return x, y


def reconstruct_batched(
    corners,
    basis: Basis2D,
    form_order: UnknownFormOrder,
    dofs,
    xi,
    eta,
) -> np.ndarray:
    """Point values of a k-form for a whole batch of elements (NumPy).

    ``corners`` is ``[E, 4, 2]``, ``dofs`` is ``[E, n]``; returns
    ``[E, *grid]`` (with a trailing component axis for 1-forms).  Identical
    math to :func:`reconstruct`, vectorized over elements for the output
    grids (the per-leaf host loop dominated solve wall time otherwise).
    """
    form_order = UnknownFormOrder(form_order)
    c = np.asarray(dofs, np.float64)
    corners = np.asarray(corners, np.float64)
    p1 = basis.basis_xi.order
    p2 = basis.basis_eta.order
    xi = np.asarray(xi, np.float64)
    eta = np.asarray(eta, np.float64)
    grid_shape = np.broadcast(xi, eta).shape
    npts = int(np.prod(grid_shape))

    def flat(vals2d):
        # x.shape + (n,) -> (npts, n)
        return np.broadcast_to(
            vals2d, grid_shape + (vals2d.shape[-1],)
        ).reshape(npts, -1)

    if form_order == UnknownFormOrder.FORM_ORDER_0:
        vx = flat(lagrange1d(basis.basis_xi.roots, xi))
        ve = flat(lagrange1d(basis.basis_eta.roots, eta))
        # basis index (i2, i1) -> i2 * (p1+1) + i1
        table = (ve[:, :, None] * vx[:, None, :]).reshape(npts, -1)
        return (c @ table.T).reshape((c.shape[0],) + grid_shape)

    j00, j01, j10, j11, det = _jacobian_np(corners, xi, eta)

    ex = flat(-np.cumsum(dlagrange1d(basis.basis_xi.roots, xi)[..., :-1], axis=-1))
    ee = flat(-np.cumsum(dlagrange1d(basis.basis_eta.roots, eta)[..., :-1], axis=-1))

    if form_order == UnknownFormOrder.FORM_ORDER_1:
        vx = flat(lagrange1d(basis.basis_xi.roots, xi))
        ve = flat(lagrange1d(basis.basis_eta.roots, eta))
        n_h = p1 * (p2 + 1)
        table_h = (ve[:, :, None] * ex[:, None, :]).reshape(npts, -1)
        table_v = (ee[:, :, None] * vx[:, None, :]).reshape(npts, -1)
        out_eta = (c[:, :n_h] @ table_h.T).reshape((c.shape[0],) + grid_shape)
        out_xi = (c[:, n_h:] @ table_v.T).reshape((c.shape[0],) + grid_shape)
        fx = (out_xi * j00 + out_eta * j10) / det
        fy = (out_xi * j01 + out_eta * j11) / det
        return np.stack((fx, fy), axis=-1)

    if form_order == UnknownFormOrder.FORM_ORDER_2:
        table = (ee[:, :, None] * ex[:, None, :]).reshape(npts, -1)
        vals = (c @ table.T).reshape((c.shape[0],) + grid_shape)
        return vals / det

    raise ValueError(f"Order of the differential form {form_order} is not valid.")
