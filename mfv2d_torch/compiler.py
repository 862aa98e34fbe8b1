"""Lowering of k-form systems to matrix-operation IR.

The IR mirrors the reference stack-machine ops (python/mfv2d/eval.py:32-145):
``Identity``, ``MassMat``, ``Incidence``, ``Push``, ``Scale``, ``Sum`` and
``InterProd``.  Instead of serializing to C bytecode, the ops are consumed
eagerly by :mod:`mfv2d_torch.evaluation`, which runs one batched computation
per order bucket.

Semantics (matching src/evaluation/element_eval.c:399-479): ops execute left
to right, each op LEFT-multiplies the "current" matrix, so a block evaluates
to ``op_n @ ... @ op_1 [@ initial]``.  ``Push`` stashes the current matrix and
restarts (re-seeded with the initial operand when evaluating vectors);
``Sum(n)`` adds the top ``n`` stack entries to the current matrix.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from enum import IntEnum

from mfv2d_torch.kform import (
    Function2D,
    KBoundaryProjection,
    KElementProjection,
    KForm,
    KFormDerivative,
    KFormUnknown,
    KInnerProduct,
    KInteriorProduct,
    KInteriorProductLowered,
    KSum,
    KWeight,
    UnknownFormOrder,
    extract_base_form,
)
from mfv2d_torch.system import KFormSystem


@dataclass(frozen=True)
class MatOp:
    """Base class of matrix operations."""


@dataclass(frozen=True)
class Identity(MatOp):
    """No-op placeholder (keeps the stack-machine semantics explicit)."""


@dataclass(frozen=True)
class MassMat(MatOp):
    """Left-multiply by the mass matrix (or its inverse) of a form order."""

    order: UnknownFormOrder
    inv: bool


@dataclass(frozen=True)
class Incidence(MatOp):
    """Left-multiply by an incidence matrix E^{(k+1,k)} (or its transpose)."""

    begin: UnknownFormOrder
    transpose: int


@dataclass(frozen=True)
class Push(MatOp):
    """Push the current matrix on the stack and restart."""


@dataclass(frozen=True)
class Scale(MatOp):
    """Scale the current matrix by a constant."""

    k: float


@dataclass(frozen=True)
class Sum(MatOp):
    """Sum the top ``count`` stack entries into the current matrix."""

    count: int


@dataclass(frozen=True)
class InterProd(MatOp):
    """Left-multiply by the field-weighted interior-product matrix.

    ``starting_order`` is the order of the form the product is applied to
    (1 -> node_edge block with +1 sign, 2 -> edge_surf block with -1 sign).
    ``field`` is either a callable (static vector field) or the label of an
    unknown 1-form (nonlinear advection field).
    """

    starting_order: UnknownFormOrder
    field: str | Function2D
    transpose: bool


def simplify_expression(*operations: MatOp) -> list[MatOp]:
    """Peephole optimizer: drops identities, cancels M @ M^-1, merges scales.

    Mirrors the rewrite rules of the reference (eval.py:148-289).
    """
    ops = list(operations)
    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(ops):
            op = ops[i]
            nxt = ops[i + 1] if i + 1 < len(ops) else None

            # Identity is a no-op unless it is the seed before Push/Sum.
            if (
                type(op) is Identity
                and nxt is not None
                and type(nxt) is not Sum
                and type(nxt) is not Push
            ):
                del ops[i]
                changed = True
                continue

            # M @ M^-1 (or M^-1 @ M) cancels.
            if (
                type(op) is MassMat
                and type(nxt) is MassMat
                and op.order == nxt.order
                and op.inv != nxt.inv
            ):
                del ops[i + 1]
                ops[i] = Identity()
                changed = True
                continue

            # Merge adjacent Identity/Scale pairs.
            if type(op) in (Scale, Identity) and type(nxt) in (Scale, Identity):
                k1 = op.k if type(op) is Scale else 1.0
                k2 = nxt.k if type(nxt) is Scale else 1.0
                merged: MatOp = (
                    Identity() if k1 * k2 == 1.0 and type(op) is Identity and type(nxt) is Identity else Scale(k1 * k2)
                )
                del ops[i + 1]
                ops[i] = merged
                changed = True
                continue

            # Sum of zero entries is a no-op.
            if type(op) is Sum and op.count == 0:
                del ops[i]
                changed = True
                continue

            # Push (I|S) Push (I|S) Sum  ->  precompute the scalar sum.
            if (
                type(op) is Push
                and i + 4 < len(ops)
                and type(ops[i + 1]) in (Scale, Identity)
                and type(ops[i + 2]) is Push
                and type(ops[i + 3]) in (Scale, Identity)
                and type(ops[i + 4]) is Sum
            ):
                v1 = ops[i + 1].k if type(ops[i + 1]) is Scale else 1.0
                v2 = ops[i + 3].k if type(ops[i + 3]) is Scale else 1.0
                ops[i + 1] = Scale(v1 + v2)
                sop = ops[i + 4]
                assert type(sop) is Sum
                ops[i + 4] = Sum(sop.count - 1)
                del ops[i + 3]
                del ops[i + 2]
                changed = True
                continue

            # Trailing identity after something other than Push is a no-op.
            if i > 0 and type(op) is Identity and type(ops[i - 1]) is not Push:
                del ops[i]
                changed = True
                continue

            i += 1
    return ops


def _translate_form(form: KForm) -> list[MatOp]:
    """Lower a form expression into ops applied to the base unknown's DoFs."""
    if isinstance(form, (KFormUnknown, KWeight)):
        return [Identity()]
    if isinstance(form, KFormDerivative):
        return _translate_form(form.form) + [Incidence(form.form.order, False)]
    if isinstance(form, KInteriorProduct):
        return _translate_form(form.form) + [
            InterProd(form.form.order, form.vector_field, False),
            MassMat(form.order, True),
        ]
    if isinstance(form, KInteriorProductLowered):
        return _translate_form(form.form) + [
            InterProd(form.form.order, form.form_field.label, False),
            MassMat(form.order, True),
        ]
    raise TypeError(f"Unknown form type {type(form)}")


def _translate_inner_prod(inner: KInnerProduct) -> list[MatOp]:
    """Lower an inner product: unknown ops, mass matrix, transposed weight ops."""
    unknown_ops = _translate_form(inner.unknown_form)
    weight_ops = _translate_form(inner.weight_form)

    unknown_ops.append(MassMat(inner.unknown_form.order, False))

    for op in reversed(weight_ops):
        if type(op) is Identity:
            continue
        if type(op) is Incidence:
            unknown_ops.append(Incidence(op.begin, not op.transpose))
        elif type(op) in (MassMat, Scale):
            unknown_ops.append(op)  # symmetric
        elif type(op) is InterProd:
            unknown_ops.append(
                InterProd(op.starting_order, op.field, not op.transpose)
            )
        else:
            raise TypeError("Unexpected type for inner product instructions.")

    if len(unknown_ops) > 1:
        return unknown_ops[1:]
    return unknown_ops


def translate_implicit_ksum(ks: KSum) -> dict[KFormUnknown, list[MatOp]]:
    """Lower a sum of inner products into per-unknown op lists."""
    instructions: dict[KFormUnknown, list[list[MatOp]]] = {}
    for k, ip in ks.pairs:
        if type(ip) is not KInnerProduct:
            raise TypeError("Can only translate implicit terms.")
        ops = _translate_inner_prod(ip)
        if k != 1.0:
            ops = ops + [Scale(k)]
        base = extract_base_form(ip.unknown_form)
        assert type(base) is KFormUnknown
        instructions.setdefault(base, []).append(ops)

    out: dict[KFormUnknown, list[MatOp]] = {}
    for form, op_list in instructions.items():
        merged = list(op_list[0])
        for extra in op_list[1:]:
            merged.append(Push())
            merged.extend(extra)
        if len(op_list) > 1:
            merged.append(Sum(len(op_list) - 1))
        out[form] = simplify_expression(*merged)
    return out


class MatOpCode(IntEnum):
    """Serialized op codes (kept for printing/testing parity with the ref)."""

    INVALID = 0
    IDENTITY = 1
    MASS = 2
    INCIDENCE = 3
    PUSH = 4
    SCALE = 5
    SUM = 6
    INTERPROD = 7


def translate_to_codes(*ops: MatOp):
    """Serialize ops to tuples (the reference's C-interface format)."""
    out = []
    for op in ops:
        if type(op) is Identity:
            out.append((MatOpCode.IDENTITY,))
        elif type(op) is MassMat:
            out.append((MatOpCode.MASS, op.order, op.inv))
        elif type(op) is Incidence:
            out.append((MatOpCode.INCIDENCE, op.begin, op.transpose))
        elif type(op) is Push:
            out.append((MatOpCode.PUSH,))
        elif type(op) is Scale:
            out.append((MatOpCode.SCALE, op.k))
        elif type(op) is Sum:
            out.append((MatOpCode.SUM, op.count))
        elif type(op) is InterProd:
            out.append(
                (MatOpCode.INTERPROD, op.starting_order, op.field, op.transpose)
            )
        else:
            raise TypeError(f"Unknown instruction type {type(op).__name__}.")
    return tuple(out)


BlockOps = tuple[MatOp, ...] | None
SystemBlocks = tuple[tuple[BlockOps, ...], ...]


def _row_for_expr(system: KFormSystem, expr: KSum | None) -> tuple[BlockOps, ...]:
    if expr is None:
        return (None,) * len(system.unknown_forms)
    blocks = translate_implicit_ksum(expr)
    row: list[BlockOps] = []
    for f in system.unknown_forms.iter_forms():
        ops = blocks.get(f)
        row.append(tuple(ops) if ops is not None else None)
    return tuple(row)


def collect_fields(*block_sets: SystemBlocks | None) -> tuple:
    """Ordered unique list of interior-product fields over all blocks.

    Each entry is either a callable (static field, host-evaluated) or a
    string (unknown 1-form label, reconstructed on device from the DoFs).
    Mirrors the field collection of system_template.c:37-163.
    """
    fields: list = []
    for blocks in block_sets:
        if blocks is None:
            continue
        for row in blocks:
            for block in row:
                if block is None:
                    continue
                for op in block:
                    if type(op) is InterProd and op.field not in fields:
                        fields.append(op.field)
    return tuple(fields)


class CompiledSystem:
    """Compiled system: LHS/RHS/linear/nonlinear block op matrices.

    Mirrors the split of the reference ``CompiledSystem`` (eval.py:533-628).
    """

    lhs_blocks: SystemBlocks
    rhs_blocks: SystemBlocks | None
    linear_blocks: SystemBlocks
    nonlin_blocks: SystemBlocks | None
    fields: tuple

    def __init__(self, system: KFormSystem) -> None:
        implicit_rhs: list[KSum | None] = []
        linear_lhs: list[KSum | None] = []
        nonlin_lhs: list[KSum | None] = []
        for equation in system.equations:
            assert not equation.left.explicit_terms
            rhs_impl = equation.right.implicit_terms
            implicit_rhs.append(KSum(*rhs_impl) if rhs_impl else None)
            linear, nonlinear = equation.left.split_terms_linear_nonlinear()
            linear_lhs.append(linear)
            nonlin_lhs.append(nonlinear)

        rhs_blocks = tuple(_row_for_expr(system, e) for e in implicit_rhs)
        self.rhs_blocks = (
            rhs_blocks
            if any(any(b is not None for b in row) for row in rhs_blocks)
            else None
        )
        self.linear_blocks = tuple(_row_for_expr(system, e) for e in linear_lhs)
        nonlin_blocks = tuple(_row_for_expr(system, e) for e in nonlin_lhs)
        self.nonlin_blocks = (
            nonlin_blocks
            if any(any(b is not None for b in row) for row in nonlin_blocks)
            else None
        )
        self.lhs_blocks = tuple(_row_for_expr(system, eq.left) for eq in system.equations)
        self.fields = collect_fields(
            self.lhs_blocks, self.rhs_blocks, self.nonlin_blocks
        )

    # Aliases matching the reference attribute names.
    @property
    def lhs_codes(self) -> SystemBlocks:
        return self.lhs_blocks

    @property
    def rhs_codes(self) -> SystemBlocks | None:
        return self.rhs_blocks

    @property
    def linear_codes(self) -> SystemBlocks:
        return self.linear_blocks

    @property
    def nonlin_codes(self) -> SystemBlocks | None:
        return self.nonlin_blocks


def _ops_to_str(*ops: MatOp) -> str:
    out: list[str] = []
    for op in reversed(ops):
        if type(op) is Identity:
            out.append("I")
        elif type(op) is MassMat:
            base = f"M({op.order.value - 1})"
            out.append(f"({base})^{{-1}}" if op.inv else base)
        elif type(op) is Incidence:
            base = f"E({op.begin.value}, {op.begin.value - 1})"
            out.append(f"({base})^T" if op.transpose else base)
        elif type(op) is InterProd:
            name = op.field if type(op.field) is str else op.field.__name__
            base = (
                f"P({op.starting_order.value - 2}, {op.starting_order.value - 1},"
                f" {name})"
            )
            out.append(f"({base})^T" if op.transpose else base)
        elif type(op) is Scale:
            out.append(str(op.k))
        else:
            raise TypeError(f"Unsupported instruction type {type(op)}.")
    return " ".join(out)


def _expr_to_str(*ops: MatOp) -> str:
    if not ops or type(ops[-1]) is not Sum:
        return _ops_to_str(*ops)
    out = ""
    begin = 0
    for i, op in enumerate(ops):
        if type(op) is Push:
            out += f"+ ({_ops_to_str(*ops[begin:i])})"
            begin = i + 1
    out += f" + ({_ops_to_str(*ops[begin:-1])})"
    return out.strip()


def _explicit_ksum_as_string(ks: KSum) -> str:
    res = ""
    for k, ip in ks.pairs:
        if type(ip) is KInnerProduct:
            continue
        if isinstance(ip, KElementProjection):
            if ip.func is None:
                continue
            out = "E" + ip.label
        elif isinstance(ip, KBoundaryProjection):
            if ip.func is None:
                continue
            out = "B" + ip.label
        else:
            continue
        if k != 1.0:
            out = f"{abs(k):g} * {out}"
        out = ("- " if k < 0 else "+ ") + out
        res = res + " " + out
    return res.strip()


def _blocks_as_rows(
    system: KFormSystem, bytecodes: Sequence[Mapping[KFormUnknown, list[MatOp]]]
) -> list[str]:
    matrix = [
        [
            (_expr_to_str(*codes[form]) if form in codes else "0")
            for form in system.unknown_forms.iter_forms()
        ]
        for codes in bytecodes
    ]
    n = len(matrix)
    for col in range(len(system.unknown_forms)):
        width = max(max((len(matrix[row][col]) for row in range(n)), default=1), 1)
        for row in range(n):
            matrix[row][col] = matrix[row][col].ljust(width)
    return [" | ".join(row) for row in matrix]


def system_as_string(system: KFormSystem, /) -> str:
    """Pretty-print the system in block-matrix form (reference eval.py:693)."""
    left_bytecodes = [translate_implicit_ksum(eq.left) for eq in system.equations]
    left_rows = _blocks_as_rows(system, left_bytecodes)

    right_bytecodes = [
        (
            translate_implicit_ksum(KSum(*eq.right.implicit_terms))
            if eq.right.implicit_terms
            else {}
        )
        for eq in system.equations
    ]
    right_rows = _blocks_as_rows(system, right_bytecodes)

    unknowns = [str(w.base_form) for w in system.weight_forms]
    uw = max(len(u) for u in unknowns)
    unknowns = [u.ljust(uw) for u in unknowns]
    left_rows = [f"[{row}] [{u}]" for u, row in zip(unknowns, left_rows)]
    right_rows = [f"[{row}] [{u}]" for u, row in zip(unknowns, right_rows)]

    explicit_rows = [_explicit_ksum_as_string(eq.right) for eq in system.equations]
    ew = max((len(r) for r in explicit_rows), default=0)
    n = len(explicit_rows)
    explicit_rows = [
        "[" + (r if r else "+ 0").ljust(ew) + "]" for r in explicit_rows
    ]

    return "\n".join(
        l_row
        + (" = " if row == n // 2 else "   ")
        + r_exp
        + (" + " if row == n // 2 else "   ")
        + r_row
        for row, (l_row, r_row, r_exp) in enumerate(
            zip(left_rows, right_rows, explicit_rows)
        )
    )
