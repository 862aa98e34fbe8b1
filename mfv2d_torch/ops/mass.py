"""Batched element mass and interior-product matrices.

This module replaces the reference's per-element quadrature triple loops
(src/fem_space/fem_space.c:235-1055) with *batched* contractions over all
elements of an order bucket at once.  Every matrix has the form

    M[e] = B_w @ diag(k[e]) @ B_u^T

where ``B_w``/``B_u`` are small per-order basis tables shared by the whole
batch and ``k[e]`` is a per-element metric factor at the quadrature points.
Each gram is one batched GEMM ``(B_w * k[e]) @ B_u^T``.

All arrays are laid out with the quadrature grid flattened eta-major:
``q = a * n_xi_pts + b`` for eta point ``a`` and xi point ``b``.  The basis
tables stay NumPy; a product reads their copies in the dtype and on the
device of the metric factors from the basis's device tables
(:mod:`mfv2d_torch.ops.device_tables`), uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from mfv2d_torch.ops.basis import Basis2D, FemCache
from mfv2d_torch.ops.device_tables import Tables
from mfv2d_torch.ops.geometry import JacobianTerms, jacobian
from mfv2d_torch.transfer import to_device


@dataclass(frozen=True)
class TensorBasis:
    """Tensor-product basis tables flattened over the quadrature grid.

    Attributes are ``(n_basis, n_quad)`` NumPy arrays:
      - ``b0``: nodal x nodal (0-form basis)
      - ``bh``: edge-xi x node-eta (1-form eta-component block)
      - ``bv``: node-xi x edge-eta (1-form xi-component block)
      - ``b2``: edge x edge (2-form basis)
    plus the quadrature weights ``w`` of shape ``(n_quad,)``.  ``tables``
    holds their device copies and those of anything else defined by the
    orders (incidence matrices, the M1 kernel's padded table).
    """

    p1: int
    p2: int
    b0: np.ndarray
    bh: np.ndarray
    bv: np.ndarray
    b2: np.ndarray
    w: np.ndarray
    nodes_xi: np.ndarray
    nodes_eta: np.ndarray
    # 1D factors (basis, 1D-points) for sum-factorized assembly.
    node_xi: np.ndarray = None
    edge_xi: np.ndarray = None
    node_eta: np.ndarray = None
    edge_eta: np.ndarray = None
    tables: Tables = field(default_factory=Tables, init=False, repr=False, compare=False)

    def tensor(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The table ``name`` (an attribute) in ``like``'s dtype on its
        device, uploaded at the first request."""
        return self.tables.like(name, lambda: getattr(self, name), like)

    def factors(self, name: str):
        """(eta-table, xi-table) pair whose kron equals the named table."""
        eta, xi = FACTORS[name]
        return getattr(self, eta), getattr(self, xi)


def tensor_basis(basis: Basis2D) -> TensorBasis:
    """The flattened tensor-product tables of a 2D basis.

    The tables depend only on the orders and the integration orders, so one
    ``TensorBasis`` serves every batch of those orders, and its device
    tables with it.  The 64 most recently requested stay memoized."""
    bx = basis.basis_xi
    be = basis.basis_eta
    return _tensor_basis(bx.order, be.order, bx.rule.order, be.rule.order)


@lru_cache(maxsize=64)
def _tensor_basis(p1: int, p2: int, int1: int, int2: int) -> TensorBasis:
    basis = FemCache(0).get_basis2d(p1, p2, int1, int2)
    bx = basis.basis_xi
    be = basis.basis_eta
    return TensorBasis(
        p1=bx.order,
        p2=be.order,
        b0=np.kron(be.node, bx.node),
        bh=np.kron(be.node, bx.edge),
        bv=np.kron(be.edge, bx.node),
        b2=np.kron(be.edge, bx.edge),
        w=np.kron(be.rule.weights, bx.rule.weights),
        nodes_xi=bx.rule.nodes,
        nodes_eta=be.rule.nodes,
        node_xi=bx.node,
        edge_xi=bx.edge,
        node_eta=be.node,
        edge_eta=be.edge,
    )


def as_like(arr, like: torch.Tensor) -> torch.Tensor:
    """A host array as a new tensor of ``like``'s dtype and device; a tensor
    moved there (itself where it is there already).  For per-call data: a
    constant table comes from its owner's device tables."""
    if isinstance(arr, torch.Tensor):
        return to_device(arr, like.device, like.dtype)
    return to_device(np.asarray(arr), like.device, like.dtype, copy=True)


def batch_jacobian(tb: TensorBasis, corners) -> JacobianTerms:
    """Jacobian terms at the quadrature grid, flattened to ``[..., n_quad]``.

    The computation follows the dtype and device of ``corners``; every term
    comes back contiguous.
    """
    c = corners if isinstance(corners, torch.Tensor) else torch.tensor(corners)
    jac = jacobian(c, tb.tensor("nodes_xi", c)[None, :], tb.tensor("nodes_eta", c)[:, None])
    flat = tuple(v.reshape(v.shape[:-2] + (-1,)).contiguous() for v in jac)
    return JacobianTerms(*flat)


def weighted_gram(bw, bu, k: torch.Tensor) -> torch.Tensor:
    """``out[e] = bw @ diag(k[e]) @ bu^T`` as one batched GEMM.

    ``bw: (nw, nq)``, ``bu: (nu, nq)``, ``k: (E, nq)`` -> ``(E, nw, nu)``;
    the tables are host arrays or tensors.
    """
    bw = as_like(bw, k)
    bu = as_like(bu, k)
    return torch.matmul(bw[None, :, :] * k[:, None, :], bu.T)


def _sum_factorization_enabled(p1: int, p2: int) -> bool:
    from mfv2d_torch.config import config as _cfg

    mode = _cfg.sum_factorization
    if mode == "always":
        return True
    if mode == "never":
        return False
    # auto: the CPU crossover measured for the JAX package is p=5 (1.6x
    # there, 2.9x at p=7); below that the extra contraction costs more than
    # the flops saved.
    return max(p1, p2) >= 5


def factored_gram(wy, wx, uy, ux, k: torch.Tensor) -> torch.Tensor:
    """Sum-factorized gram: exploits the tensor-product quadrature grid.

    ``wy/uy: (n_eta, s2)``, ``wx/ux: (n_xi, s1)``, ``k: (E, s2*s1)``
    (eta-major) -> ``(E, n_w, n_u)``; the tables are host arrays or
    tensors.  Same result as
    ``weighted_gram(kron(wy, wx), kron(uy, ux), k)`` with ~5.5x fewer flops
    at p=4 (more at higher order); reference fem_space.c does the full
    O(p^4 q^2) loop.
    """
    s2 = wy.shape[1]
    s1 = wx.shape[1]
    e = k.shape[0]
    k2 = k.reshape(e, s2, s1)
    wy, wx, uy, ux = (as_like(v, k) for v in (wy, wx, uy, ux))
    t = torch.einsum("ia,ja,eba->ebij", wx, ux, k2)
    m = torch.einsum("Ib,Jb,ebij->eIiJj", wy, uy, t)
    return m.reshape(e, wy.shape[0] * wx.shape[0], uy.shape[0] * ux.shape[0])


# The 1D factors (eta, xi) whose kron is each flattened table.
FACTORS = {
    "b0": ("node_eta", "node_xi"),
    "bh": ("node_eta", "edge_xi"),
    "bv": ("edge_eta", "node_xi"),
    "b2": ("edge_eta", "edge_xi"),
}


def gram(tb_w: TensorBasis, name_w: str, tb_u: TensorBasis, name_u: str, k):
    """Dispatch between the single-GEMM and sum-factorized gram paths."""
    if _sum_factorization_enabled(tb_w.p1, tb_w.p2):
        if tb_w.factors(name_w)[0] is not None and tb_u.factors(name_u)[0] is not None:
            wy, wx = (tb_w.tensor(n, k) for n in FACTORS[name_w])
            uy, ux = (tb_u.tensor(n, k) for n in FACTORS[name_u])
            return factored_gram(wy, wx, uy, ux, k)
    return weighted_gram(tb_w.tensor(name_w, k), tb_u.tensor(name_u, k), k)


def mass_node(tb: TensorBasis, jac: JacobianTerms):
    """M0: 0-form mass matrices ``[E, n0, n0]`` (fem_space.c:235)."""
    k = jac.det * tb.tensor("w", jac.det)
    return gram(tb, "b0", tb, "b0", k)


def mass_surf(tb: TensorBasis, jac: JacobianTerms):
    """M2: 2-form mass matrices ``[E, n2, n2]`` (fem_space.c:377)."""
    k = tb.tensor("w", jac.det) / jac.det
    return gram(tb, "b2", tb, "b2", k)


def _edge_metric(jac: JacobianTerms, w):
    """The 1-form metric factors ``(k_hh, k_vv, k_hv)``, each ``[E, nq]``,
    for the weights ``w`` (a host array or a tensor)."""
    wdt = as_like(w, jac.det)
    k_hh = (jac.j10 * jac.j10 + jac.j11 * jac.j11) / jac.det * wdt
    k_vv = (jac.j00 * jac.j00 + jac.j01 * jac.j01) / jac.det * wdt
    k_hv = (jac.j00 * jac.j10 + jac.j01 * jac.j11) / jac.det * wdt
    return k_hh, k_vv, k_hv


def mass_edge(tb: TensorBasis, jac: JacobianTerms, field=None):
    """M1: 1-form mass matrices ``[E, n1, n1]`` with metric terms.

    Block layout is ``[eta-component (h), xi-component (v)]`` as in
    fem_space.c:271-375.  If ``field`` (a ``[E, nq]`` scalar) is given, the
    metric is weighted by it (the primal edge-edge interior product variant,
    fem_space.c:638-721).

    Without ``field`` this is the plain version of the hand-written kernel
    in :mod:`mfv2d_torch.ops.kernels.mass_edge`.
    """
    k_hh, k_vv, k_hv = _edge_metric(jac, tb.tensor("w", jac.det))
    if field is not None:
        k_hh = k_hh * field
        k_vv = k_vv * field
        k_hv = k_hv * field
    m_hh = gram(tb, "bh", tb, "bh", k_hh)
    m_vv = gram(tb, "bv", tb, "bv", k_vv)
    m_hv = gram(tb, "bh", tb, "bv", k_hv)
    top = torch.cat([m_hh, m_hv], dim=2)
    bot = torch.cat([m_hv.transpose(1, 2), m_vv], dim=2)
    return torch.cat([top, bot], dim=1)


def mass_edge_edge_dual(tb: TensorBasis, jac: JacobianTerms, field):
    """Dual edge-edge interior product matrix (fem_space.c:722-745).

    Antisymmetric: ``[[0, +B], [-B^T, 0]]`` with
    ``B = bh @ diag(field w / det) @ bv^T``.
    """
    k = field * tb.tensor("w", jac.det) / jac.det
    b = gram(tb, "bh", tb, "bv", k)
    e = b.shape[0]
    n_h = tb.bh.shape[0]
    n_v = tb.bv.shape[0]
    zero_hh = b.new_zeros((e, n_h, n_h))
    zero_vv = b.new_zeros((e, n_v, n_v))
    top = torch.cat([zero_hh, b], dim=2)
    bot = torch.cat([-b.transpose(1, 2), zero_vv], dim=2)
    return torch.cat([top, bot], dim=1)


def mass_node_edge(tb: TensorBasis, jac: JacobianTerms, field, transpose: bool):
    """Interior product of a 1-form with a vector field -> 0-form block.

    ``field`` is ``[E, nq, 2]`` physical (x, y) components at quadrature
    points.  Matches fem_space.c:546-635: the eta-component columns use
    ``F_x j11 - F_y j10`` and the xi-component columns ``F_x j01 - F_y j00``.
    """
    wdt = tb.tensor("w", jac.det)
    comp_h = (field[..., 0] * jac.j11 - field[..., 1] * jac.j10) * wdt
    comp_v = (field[..., 0] * jac.j01 - field[..., 1] * jac.j00) * wdt
    m_h = gram(tb, "b0", tb, "bh", comp_h)
    m_v = gram(tb, "b0", tb, "bv", comp_v)
    mat = torch.cat([m_h, m_v], dim=2)
    if transpose:
        return mat.transpose(1, 2)
    return mat


def mass_edge_surf(tb: TensorBasis, jac: JacobianTerms, field, transpose: bool):
    """Interior product of a 2-form with a vector field -> 1-form block.

    Matches fem_space.c:752-846: rows are [h, v] 1-form blocks, columns are
    2-form DoFs; components ``-(F_x j10 + F_y j11)/det`` (h) and
    ``-(F_x j00 + F_y j01)/det`` (v).
    """
    wdt = tb.tensor("w", jac.det)
    comp_h = -(field[..., 0] * jac.j10 + field[..., 1] * jac.j11) / jac.det * wdt
    comp_v = -(field[..., 0] * jac.j00 + field[..., 1] * jac.j01) / jac.det * wdt
    m_h = gram(tb, "bh", tb, "b2", comp_h)
    m_v = gram(tb, "bv", tb, "b2", comp_v)
    mat = torch.cat([m_h, m_v], dim=1)
    if transpose:
        return mat.transpose(1, 2)
    return mat


def mass_node_double(tb_in: TensorBasis, tb_out: TensorBasis, jac: JacobianTerms):
    """Cross-space 0-form mass ``[E, n0_out, n0_in]`` (fem_space.c:847)."""
    k = jac.det * tb_in.tensor("w", jac.det)
    return gram(tb_out, "b0", tb_in, "b0", k)


def mass_surf_double(tb_in: TensorBasis, tb_out: TensorBasis, jac: JacobianTerms):
    """Cross-space 2-form mass ``[E, n2_out, n2_in]`` (fem_space.c:1011)."""
    k = tb_in.tensor("w", jac.det) / jac.det
    return gram(tb_out, "b2", tb_in, "b2", k)


def mass_edge_double(tb_in: TensorBasis, tb_out: TensorBasis, jac: JacobianTerms):
    """Cross-space 1-form mass ``[E, n1_out, n1_in]`` (fem_space.c:888)."""
    k_hh, k_vv, k_hv = _edge_metric(jac, tb_in.tensor("w", jac.det))
    m_hh = gram(tb_out, "bh", tb_in, "bh", k_hh)
    m_vv = gram(tb_out, "bv", tb_in, "bv", k_vv)
    m_hv = gram(tb_out, "bh", tb_in, "bv", k_hv)
    m_vh = gram(tb_out, "bv", tb_in, "bh", k_hv)
    top = torch.cat([m_hh, m_hv], dim=2)
    bot = torch.cat([m_vh, m_vv], dim=2)
    return torch.cat([top, bot], dim=1)
