"""One-GEMM-per-term element assembly.

The stack-machine evaluator (:mod:`mfv2d_torch.evaluation`) computes each
block as a chain of batched ``[E, r, q] @ [E, q, c]`` products — small
per-element GEMMs.  This module exploits that every block of an element
system is *linear in the per-element metric factors*:

    block[e] = sum_t coef_t * L_t @ (B_w,t diag(k_t[e]) B_u,t^T) @ R_t

where ``B_*`` are constant basis tables, ``L/R`` constant incidence
compositions, and ``k_t[e]`` an ``[E, nq]`` metric/field factor.  Folding the
constants gives

    block[e].ravel() = k_t[e] @ C_t,   C_t[s, (i, j)] = row_t[i, s] col_t[j, s]

— a single wide-N GEMM ``[E, nq] @ [nq, r*c]`` per term.  Terms sharing a
destination sub-block stack their ``k`` columns into one GEMM.

Blocks whose op chains are not linear in the metrics (anything multiplying a
mass inverse or composing two field-weighted grams) raise :class:`NotLinear`
and fall back to the stack-machine path.

The planner (everything up to :func:`plan_block`) is host NumPy; only
:func:`evaluate_kspec` and :func:`evaluate_block_fused` run on tensors.  A
plan's pair tables and constant blocks are uploaded at their first use and
then served from the plan's device tables
(:mod:`mfv2d_torch.ops.device_tables`), which go with the plan when
:func:`_cached_plan` drops it.

Reference hot path replaced: src/evaluation/element_system.c:13 +
src/fem_space/fem_space.c:235-846.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from mfv2d_torch.compiler import (
    Identity,
    Incidence,
    InterProd,
    MassMat,
    Push,
    Scale,
    Sum,
)
from mfv2d_torch.kform import UnknownFormOrder
from mfv2d_torch.ops.device_tables import Tables
from mfv2d_torch.ops.incidence import incidence_matrix
from mfv2d_torch.ops.mass import TensorBasis, tensor_basis


class NotLinear(Exception):
    """Block is not linear in the metric factors; use the fallback path."""


# --- symbolic terms --------------------------------------------------------


@dataclass(frozen=True)
class GramTerm:
    """``coef * place(row_table) diag(k[kspec]) place(col_table)^T``.

    ``row_table``/``col_table`` are ``[h, nq]`` basis products; ``*_off`` and
    ``*_tot`` place their span inside the block's row/column dimension.
    """

    coef: float
    row_table: np.ndarray
    row_off: int
    row_tot: int
    col_table: np.ndarray
    col_off: int
    col_tot: int
    kspec: tuple


@dataclass(frozen=True)
class _Const:
    """A constant (non-batched) matrix ``coef * mat`` (``mat=None`` = I)."""

    coef: float
    mat: np.ndarray | None

    def matrix(self, n: int) -> np.ndarray:
        base = np.eye(n) if self.mat is None else self.mat
        return self.coef * base


class _Terms:
    """A sum of gram terms plus an optional constant remainder."""

    __slots__ = ("grams", "consts")

    def __init__(self, grams: list[GramTerm], consts: list[_Const]):
        self.grams = grams
        self.consts = consts


# --- gram structure of masses and interior products ------------------------


def _mass_grams(order: UnknownFormOrder, tb: TensorBasis) -> list[GramTerm]:
    nh = tb.bh.shape[0]
    nv = tb.bv.shape[0]
    n1 = nh + nv
    if order == UnknownFormOrder.FORM_ORDER_0:
        n0 = tb.b0.shape[0]
        return [GramTerm(1.0, tb.b0, 0, n0, tb.b0, 0, n0, ("wdet",))]
    if order == UnknownFormOrder.FORM_ORDER_2:
        n2 = tb.b2.shape[0]
        return [GramTerm(1.0, tb.b2, 0, n2, tb.b2, 0, n2, ("wodet",))]
    if order == UnknownFormOrder.FORM_ORDER_1:
        return [
            GramTerm(1.0, tb.bh, 0, n1, tb.bh, 0, n1, ("hh",)),
            GramTerm(1.0, tb.bh, 0, n1, tb.bv, nh, n1, ("hv",)),
            GramTerm(1.0, tb.bv, nh, n1, tb.bh, 0, n1, ("hv",)),
            GramTerm(1.0, tb.bv, nh, n1, tb.bv, nh, n1, ("vv",)),
        ]
    raise NotLinear(f"mass order {order}")


def _interprod_grams(op: InterProd, tb: TensorBasis) -> tuple[list[GramTerm], float]:
    """Grams + overall sign, matching evaluation._interprod_matrix."""
    nh = tb.bh.shape[0]
    nv = tb.bv.shape[0]
    n1 = nh + nv
    f = op.field
    if op.starting_order == UnknownFormOrder.FORM_ORDER_1:
        # node_edge: rows 0-form, cols [h | v] 1-form blocks.
        n0 = tb.b0.shape[0]
        grams = [
            GramTerm(1.0, tb.b0, 0, n0, tb.bh, 0, n1, ("ne_h", f)),
            GramTerm(1.0, tb.b0, 0, n0, tb.bv, nh, n1, ("ne_v", f)),
        ]
        sign = +1.0
    elif op.starting_order == UnknownFormOrder.FORM_ORDER_2:
        # edge_surf: rows [h | v] 1-form blocks, cols 2-form.
        n2 = tb.b2.shape[0]
        grams = [
            GramTerm(1.0, tb.bh, 0, n1, tb.b2, 0, n2, ("es_h", f)),
            GramTerm(1.0, tb.bv, nh, n1, tb.b2, 0, n2, ("es_v", f)),
        ]
        sign = -1.0
    else:
        raise NotLinear(f"interior product from order {op.starting_order}")
    if op.transpose:
        grams = [
            GramTerm(
                g.coef,
                g.col_table,
                g.col_off,
                g.col_tot,
                g.row_table,
                g.row_off,
                g.row_tot,
                g.kspec,
            )
            for g in grams
        ]
    return grams, sign


def _grams_times_const(grams: list[GramTerm], const: _Const) -> list[GramTerm]:
    """Right-multiply each placed gram by a constant state: ``G @ C``."""
    out = []
    for g in grams:
        if const.mat is None:
            out.append(replace(g, coef=g.coef * const.coef))
        else:
            cmat = const.mat  # [col_tot, n_state_cols]
            sub = cmat[g.col_off : g.col_off + g.col_table.shape[0], :]
            out.append(
                replace(
                    g,
                    coef=g.coef * const.coef,
                    col_table=sub.T @ g.col_table,
                    col_off=0,
                    col_tot=cmat.shape[1],
                )
            )
    return out


def _const_times_grams(mat: np.ndarray, grams: list[GramTerm]) -> list[GramTerm]:
    """Left-multiply each placed gram by a constant matrix: ``M @ G``."""
    out = []
    for g in grams:
        sub = mat[:, g.row_off : g.row_off + g.row_table.shape[0]]
        out.append(
            replace(
                g,
                row_table=sub @ g.row_table,
                row_off=0,
                row_tot=mat.shape[0],
            )
        )
    return out


# --- the linearizer (mirrors evaluation.evaluate_block semantics) ----------


def linearize_block(
    ops: Sequence, tb: TensorBasis, p1: int, p2: int
) -> tuple[tuple[GramTerm, ...], tuple[_Const, ...]]:
    """Symbolically execute a block op chain into gram + const terms.

    Raises :class:`NotLinear` when the chain multiplies two batched factors
    (mass inverse, gram-times-gram) and cannot be put in the linear form.
    """

    def inc_mat(op: Incidence) -> np.ndarray:
        kind = {
            (int(UnknownFormOrder.FORM_ORDER_0), False): 0,
            (int(UnknownFormOrder.FORM_ORDER_1), False): 1,
            (int(UnknownFormOrder.FORM_ORDER_0), True): 2,
            (int(UnknownFormOrder.FORM_ORDER_1), True): 3,
        }[(int(op.begin), bool(op.transpose))]
        return incidence_matrix(kind, p1, p2)

    current: _Const | _Terms | None = None  # None == invalid
    stack: list[_Const | _Terms | None] = []

    def to_parts(state) -> tuple[list[GramTerm], list[_Const]]:
        if state is None:
            raise NotLinear("invalid state at Sum/end")
        if isinstance(state, _Const):
            return [], [state]
        return list(state.grams), list(state.consts)

    for op in ops:
        t = type(op)
        if t is Identity:
            if current is None:
                current = _Const(1.0, None)
        elif t is Scale:
            if current is None:
                current = _Const(op.k, None)
            elif isinstance(current, _Const):
                current = _Const(current.coef * op.k, current.mat)
            else:
                current = _Terms(
                    [replace(g, coef=g.coef * op.k) for g in current.grams],
                    [_Const(c.coef * op.k, c.mat) for c in current.consts],
                )
        elif t is Push:
            stack.append(current)
            current = None
        elif t is Incidence:
            e = inc_mat(op)
            if current is None or (
                isinstance(current, _Const) and current.mat is None
            ):
                coef = current.coef if isinstance(current, _Const) else 1.0
                current = _Const(coef, e)
            elif isinstance(current, _Const):
                current = _Const(current.coef, e @ current.mat)
            else:
                if current.consts:
                    raise NotLinear("incidence times mixed const+gram state")
                current = _Terms(_const_times_grams(e, current.grams), [])
        elif t is MassMat:
            if op.inv:
                raise NotLinear("mass inverse")
            if isinstance(current, _Terms):
                raise NotLinear("mass times gram state")
            const = current if isinstance(current, _Const) else _Const(1.0, None)
            grams = _grams_times_const(_mass_grams(op.order, tb), const)
            current = _Terms(grams, [])
        elif t is InterProd:
            if isinstance(current, _Terms):
                raise NotLinear("interior product times gram state")
            const = current if isinstance(current, _Const) else _Const(1.0, None)
            grams, sign = _interprod_grams(op, tb)
            grams = _grams_times_const(grams, const)
            if sign != 1.0:
                grams = [replace(g, coef=g.coef * sign) for g in grams]
            current = _Terms(grams, [])
        elif t is Sum:
            grams, consts = to_parts(current)
            for _ in range(op.count):
                g2, c2 = to_parts(stack.pop())
                grams += g2
                consts += c2
            current = _Terms(grams, consts)
        else:
            raise NotLinear(f"unknown op {op}")

    grams, consts = to_parts(current)
    return tuple(grams), tuple(consts)


# --- trace-time evaluation --------------------------------------------------


def _pair_table(row: np.ndarray, col: np.ndarray, coef: float) -> np.ndarray:
    """``C[s, i*c + j] = coef * row[i, s] * col[j, s]`` (f64 host constant)."""
    return coef * np.einsum(
        "is,js->sij", row, col, optimize=True
    ).reshape(row.shape[1], -1)


@dataclass(frozen=True)
class _Group:
    """Terms merged onto one destination sub-block: one stacked GEMM."""

    row_off: int
    row_cnt: int
    col_off: int
    col_cnt: int
    kspecs: tuple
    table: np.ndarray  # [len(kspecs) * nq, row_cnt * col_cnt]


@dataclass(frozen=True)
class BlockPlan:
    """Fused evaluation plan for one block; ``tables`` holds the device
    copies of its group tables and constant blocks."""

    n_rows: int
    n_cols: int
    groups: tuple[_Group, ...]
    consts: tuple  # of (coef, mat | None)
    tables: Tables = field(default_factory=Tables, init=False, repr=False, compare=False)


def plan_block(ops, tb: TensorBasis, p1: int, p2: int) -> BlockPlan:
    """Linearize + group a block's terms (raises NotLinear)."""
    grams, consts = linearize_block(ops, tb, p1, p2)
    if not grams and not consts:
        raise NotLinear("empty block")
    n_rows = grams[0].row_tot if grams else None
    n_cols = grams[0].col_tot if grams else None
    for g in grams:
        if g.row_tot != n_rows or g.col_tot != n_cols:
            raise NotLinear("inconsistent block dimensions")

    by_dest: dict[tuple[int, int, int, int], list[GramTerm]] = {}
    for g in grams:
        key = (g.row_off, g.row_table.shape[0], g.col_off, g.col_table.shape[0])
        by_dest.setdefault(key, []).append(g)

    groups = []
    for (ro, rc, co, cc), terms in sorted(by_dest.items()):
        # Terms with the same kspec merge by adding tables; distinct kspecs
        # stack along the contraction axis.
        by_k: dict[tuple, np.ndarray] = {}
        for g in terms:
            tab = _pair_table(g.row_table, g.col_table, g.coef)
            if g.kspec in by_k:
                by_k[g.kspec] = by_k[g.kspec] + tab
            else:
                by_k[g.kspec] = tab
        kspecs = tuple(by_k.keys())
        table = np.concatenate([by_k[ks] for ks in kspecs], axis=0)
        groups.append(_Group(ro, rc, co, cc, kspecs, table))

    if n_rows is None:
        # Pure-constant block: dimensions come from the const matrices.
        mats = [c.mat for c in consts if c.mat is not None]
        if not mats:
            raise NotLinear("pure scaled-identity block (no dimensions)")
        n_rows, n_cols = mats[0].shape
    return BlockPlan(
        n_rows,
        n_cols,
        tuple(groups),
        tuple((c.coef, c.mat) for c in consts),
    )


def evaluate_kspec(spec: tuple, batch, fields: dict) -> torch.Tensor:
    """Evaluate a metric/field factor to an ``[E, nq]`` tensor."""
    jac = batch.jac
    w = batch.tb.tensor("w", jac.det)
    kind = spec[0]
    if kind == "wdet":
        return jac.det * w
    if kind == "wodet":
        return w / jac.det
    if kind == "hh":
        return (jac.j10 * jac.j10 + jac.j11 * jac.j11) / jac.det * w
    if kind == "vv":
        return (jac.j00 * jac.j00 + jac.j01 * jac.j01) / jac.det * w
    if kind == "hv":
        return (jac.j00 * jac.j10 + jac.j01 * jac.j11) / jac.det * w
    field = fields[spec[1]]
    fx = field[..., 0]
    fy = field[..., 1]
    if kind == "ne_h":
        return (fx * jac.j11 - fy * jac.j10) * w
    if kind == "ne_v":
        return (fx * jac.j01 - fy * jac.j00) * w
    if kind == "es_h":
        return -(fx * jac.j10 + fy * jac.j11) / jac.det * w
    if kind == "es_v":
        return -(fx * jac.j00 + fy * jac.j01) / jac.det * w
    raise ValueError(f"Unknown kspec {spec}")


def evaluate_block_fused(
    plan: BlockPlan, batch, fields: dict, k_cache: dict
) -> torch.Tensor:
    """Evaluate one block from its fused plan: one GEMM per group.

    Each group's ``k @ table`` product is added in place at its offset in a
    preallocated ``[E, n_rows, n_cols]`` output.
    """
    e = batch.n_elements
    det = batch.jac.det
    out = det.new_zeros((e, plan.n_rows, plan.n_cols))
    for i, g in enumerate(plan.groups):
        ks = []
        for spec in g.kspecs:
            if spec not in k_cache:
                k_cache[spec] = evaluate_kspec(spec, batch, fields)
            ks.append(k_cache[spec])
        k = ks[0] if len(ks) == 1 else torch.cat(ks, dim=1)
        table = plan.tables.like(("group", i), lambda: g.table, k)
        piece = (k @ table).reshape(e, g.row_cnt, g.col_cnt)
        out[:, g.row_off : g.row_off + g.row_cnt,
            g.col_off : g.col_off + g.col_cnt] += piece

    for i, (coef, mat) in enumerate(plan.consts):
        const = plan.tables.like(
            ("const", i), lambda: coef * (np.eye(plan.n_rows) if mat is None else mat), det
        )
        out = out + const
    return out


@lru_cache(maxsize=512)
def _cached_plan(ops, p1: int, p2: int, int1: int, int2: int):
    """Plan cache keyed on the op chain + orders (NotLinear cached too)."""
    from mfv2d_torch.ops.basis import FemCache

    tb = tensor_basis(FemCache(0).get_basis2d(p1, p2, int1, int2))
    try:
        return plan_block(ops, tb, p1, p2)
    except NotLinear as exc:
        return str(exc)


def try_plan(ops, batch) -> BlockPlan | None:
    """Fused plan for the block, or None when it must use the fallback."""
    p1, p2 = batch.orders
    int1, int2 = batch.basis.integration_orders
    plan = _cached_plan(ops, p1, p2, int1, int2)
    return plan if isinstance(plan, BlockPlan) else None
