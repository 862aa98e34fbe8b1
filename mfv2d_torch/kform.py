"""Differential k-form DSL.

Users describe variational systems by operator overloading:

- ``w @ u``   inner product  <w, u>
- ``u.derivative``  exterior derivative (incidence application)
- ``f * u`` / ``u * f``  interior product with a vector field callable
- ``vel * u``  interior product with an unknown 1-form (nonlinear advection)
- ``w @ func``  element projection (forcing) on the RHS
- ``w ^ func``  boundary projection (weak BC) on the RHS
- ``lhs == rhs``  equation

The surface mirrors the reference DSL (python/mfv2d/kform.py) so that every
reference example can be expressed verbatim; the lowering target is entirely
different (batched torch block evaluation instead of C bytecode, see compiler.py).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from enum import IntEnum
from typing import Literal, overload

Function2D = Callable


class UnknownFormOrder(IntEnum):
    """Order of an unknown differential form (values mirror the reference)."""

    FORM_ORDER_0 = 1
    FORM_ORDER_1 = 2
    FORM_ORDER_2 = 3

    def full_unknown_count(self, order_1: int, order_2: int) -> int:
        """Total DoF count of a form of this order on a (p1, p2) element."""
        if self == UnknownFormOrder.FORM_ORDER_0:
            return (order_1 + 1) * (order_2 + 1)
        if self == UnknownFormOrder.FORM_ORDER_1:
            return order_1 * (order_2 + 1) + (order_1 + 1) * order_2
        if self == UnknownFormOrder.FORM_ORDER_2:
            return order_1 * order_2
        raise ValueError

    @property
    def dual(self) -> UnknownFormOrder:
        """The dual form order (0 <-> 2, 1 <-> 1)."""
        return UnknownFormOrder(4 - self.value)


@dataclass(frozen=True)
class Term:
    """Base class for anything printable in an expression."""

    label: str

    def __str__(self) -> str:
        return self.label


@dataclass(frozen=True)
class KForm(Term):
    """A differential k-form expression node."""

    order: UnknownFormOrder
    label: str

    def __post_init__(self) -> None:
        object.__setattr__(self, "order", UnknownFormOrder(self.order))

    def __str__(self) -> str:
        return f"{self.label}({self.order.value - 1})"

    def __matmul__(self, other: KForm, /) -> KInnerProduct:
        if isinstance(other, KForm):
            return KInnerProduct(self, other)
        return NotImplemented

    def __mul__(self, other: Function2D, /) -> KInteriorProduct:
        if not callable(other):
            return NotImplemented
        return KInteriorProduct(
            f"i_{{{self.label}}}({other.__name__})",
            UnknownFormOrder(self.order.value - 1),
            self,
            other,
        )

    def __rmul__(self, other, /):
        if callable(other):
            return KInteriorProduct(
                f"i_{{{other.__name__}}}({self.label})",
                UnknownFormOrder(self.order.value - 1),
                self,
                other,
            )
        if type(other) is not KFormUnknown:
            return NotImplemented
        if other.order != UnknownFormOrder.FORM_ORDER_1:
            raise ValueError(
                "Interior product with a lowered form requires the field to be an"
                f" unknown 1-form (which {other} is not)."
            )
        if self.order == UnknownFormOrder.FORM_ORDER_0:
            raise ValueError("Can not take an interior product with a 0-form.")
        return KInteriorProductLowered(
            f"i_{{{other.label}}}({self.label})",
            UnknownFormOrder(self.order - 1),
            self,
            other,
        )

    @property
    def derivative(self) -> KFormDerivative:
        return KFormDerivative(self)


@dataclass(frozen=True)
class KFormUnknown(KForm):
    """An unknown form to be solved for."""

    @property
    def weight(self) -> KWeight:
        return KWeight(self.label, self.order, self)

    def __mul__(self, other, /):
        if not isinstance(other, KForm):
            return super().__mul__(other)
        if self.order != UnknownFormOrder.FORM_ORDER_1:
            raise ValueError(
                "Interior product with a lowered form requires the field to be an"
                f" unknown 1-form (which {self} is not)."
            )
        if other.order == UnknownFormOrder.FORM_ORDER_0:
            raise ValueError("Can not take an interior product with a 0-form.")
        return KInteriorProductLowered(
            f"i_{{{self.label}}}({other.label})",
            UnknownFormOrder(other.order - 1),
            other,
            self,
        )


@dataclass(frozen=True, eq=False)
class KWeight(KForm):
    """A weight (test) form, associated with a base unknown."""

    base_form: KFormUnknown

    def __str__(self) -> str:
        return f"{self.label}({self.order.value - 1}*)"

    def __matmul__(self, other, /):
        if isinstance(other, KForm):
            return KInnerProduct(other, self)
        if callable(other):
            return KElementProjection(f"<{self.label}, {other.__name__}>", self, other)
        return NotImplemented

    def __xor__(self, other: Callable) -> KBoundaryProjection:
        if callable(other):
            return KBoundaryProjection(f"<{self.label}, {other.__name__}>", self, other)
        return NotImplemented

    @property
    def is_linear(self) -> bool:
        return True


@dataclass(init=False, frozen=True, eq=False)
class KFormDerivative(KForm):
    """Exterior derivative of a form (maps k-forms to (k+1)-forms)."""

    form: KForm

    def __init__(self, form: KForm) -> None:
        object.__setattr__(self, "form", form)
        super().__init__("d" + form.label, UnknownFormOrder(form.order.value + 1))


@dataclass(frozen=True, eq=False)
class KInteriorProduct(KForm):
    """Interior product of a k-form with a known vector field callable."""

    form: KForm
    vector_field: Function2D

    def __post_init__(self) -> None:
        if self.form.order == UnknownFormOrder.FORM_ORDER_0:
            raise ValueError("Interior product can not be applied to a 0-form.")


@dataclass(frozen=True, eq=False)
class KInteriorProductLowered(KForm):
    """Interior product with an unknown 1-form (nonlinear advection term)."""

    form: KForm
    form_field: KFormUnknown

    def __post_init__(self) -> None:
        if type(self.form_field) is not KFormUnknown:
            raise TypeError(
                "Form field must be an unknown 1-form (instead it was"
                f" {type(self.form_field)})."
            )
        if self.form.order == UnknownFormOrder.FORM_ORDER_0:
            raise ValueError("Interior product can not be applied to a 0-form.")
        if self.form_field.order != UnknownFormOrder.FORM_ORDER_1:
            raise ValueError(
                "Interior product requires the field form to be a 1-form, it was"
                f" instead a {self.form_field.order.value - 1}-form."
            )


def extract_base_form(form: KForm, max_depth: int = 100) -> KFormUnknown | KWeight:
    """Strip derivatives/interior products down to the base unknown or weight."""
    for _ in range(max_depth):
        if isinstance(form, (KFormUnknown, KWeight)):
            return form
        if isinstance(form, KFormDerivative):
            form = form.form
        elif isinstance(form, (KInteriorProduct, KInteriorProductLowered)):
            form = form.form
        else:
            raise TypeError("Unknown type.")
    raise ValueError("Maximum search depth reached.")


def extract_unknown_forms(form: KForm) -> list[KFormUnknown]:
    """All unknown forms appearing in the expression (field forms included)."""
    if isinstance(form, KFormUnknown):
        return [form]
    if isinstance(form, KFormDerivative):
        return extract_unknown_forms(form.form)
    if isinstance(form, KInteriorProduct):
        return extract_unknown_forms(form.form)
    if isinstance(form, KInteriorProductLowered):
        return extract_unknown_forms(form.form) + [form.form_field]
    raise TypeError(f"Unknown forms can not be extracted from the form {form}.")


def check_form_linear(form: KForm) -> bool:
    """Is the expression linear in the unknowns?"""
    if isinstance(form, (KFormUnknown, KWeight)):
        return True
    if isinstance(form, KFormDerivative):
        return check_form_linear(form.form)
    if isinstance(form, KInteriorProductLowered):
        return False
    if isinstance(form, KInteriorProduct):
        return check_form_linear(form.form)
    raise TypeError(f"Unknown form type {type(form)}")


@dataclass(frozen=True, eq=False)
class TermEvaluatable(Term):
    """A term that can appear (scaled, summed) in an equation."""

    weight: KWeight

    def __post_init__(self) -> None:
        base = extract_base_form(self.weight)
        if type(base) is not KWeight:
            raise TypeError(f"The weight form {self.weight} is not actually a weight.")

    def __add__(self, other: TermEvaluatable, /) -> KSum:
        if isinstance(other, TermEvaluatable):
            return KSum((1.0, self), (1.0, other))
        return NotImplemented

    def __radd__(self, other: TermEvaluatable, /) -> KSum:
        return self.__add__(other)

    def __sub__(self, other: TermEvaluatable, /) -> KSum:
        if isinstance(other, TermEvaluatable):
            return KSum((1.0, self), (-1.0, other))
        return NotImplemented

    def __rsub__(self, other: TermEvaluatable, /) -> KSum:
        if isinstance(other, TermEvaluatable):
            return KSum((1.0, other), (-1.0, self))
        return NotImplemented

    def __mul__(self, other: float | int, /) -> KSum:
        try:
            v = float(other)
        except Exception:
            return NotImplemented
        return KSum((v, self))

    def __rmul__(self, other: float | int, /) -> KSum:
        return self.__mul__(other)

    def __truediv__(self, other: float | int, /) -> KSum:
        try:
            v = float(other)
        except Exception:
            return NotImplemented
        return KSum((1 / v, self))

    def __neg__(self) -> KSum:
        return KSum((-1, self))

    @overload
    def __eq__(self, other: TermEvaluatable | Literal[0], /) -> KEquation: ...

    @overload
    def __eq__(self, other, /) -> bool: ...

    def __eq__(self, other, /):
        if isinstance(other, TermEvaluatable):
            return KEquation(KSum((1.0, self)), KSum((1.0, other)))
        if isinstance(other, (int, float)) and float(other) == 0:
            return KEquation(
                KSum((1.0, self)),
                KSum((1.0, KElementProjection("0", self.weight, None))),
            )
        return self is other

    @property
    def unknowns(self) -> tuple[KFormUnknown, ...]:
        raise NotImplementedError

    @property
    def vector_fields(self) -> tuple:
        raise NotImplementedError


@dataclass(init=False, frozen=True, eq=False)
class KInnerProduct(TermEvaluatable):
    """Inner product <weight expression, unknown expression>."""

    unknown_form: KForm
    weight_form: KForm

    def __init__(self, a: KForm, b: KForm, /) -> None:
        base_a = extract_base_form(a)
        base_b = extract_base_form(b)
        a_is_weight = type(base_a) is KWeight
        b_is_weight = type(base_b) is KWeight
        if a_is_weight == b_is_weight:
            raise TypeError(
                "Inner product can only be taken between a weight and an unknown k-form."
            )
        if a_is_weight:
            weight, unknown, w = a, b, base_a
        else:
            weight, unknown, w = b, a, base_b
        if weight.order != unknown.order:
            raise ValueError(
                "The K forms are not of the same (primal) order"
                f" ({weight.order.value - 1}-form vs {unknown.order.value - 1}-form)"
            )
        object.__setattr__(self, "unknown_form", unknown)
        object.__setattr__(self, "weight_form", weight)
        assert type(w) is KWeight
        super().__init__(f"<{weight.label}, {unknown.label}>", w)

    @property
    def unknowns(self) -> tuple[KFormUnknown, ...]:
        return tuple(extract_unknown_forms(self.unknown_form))

    @property
    def vector_fields(self) -> tuple:
        out: list = []
        for expr in (self.unknown_form, self.weight_form):
            node = expr
            while True:
                if isinstance(node, KInteriorProduct):
                    out.append(node.vector_field)
                    node = node.form
                elif isinstance(node, KInteriorProductLowered):
                    out.append(node.form_field)
                    node = node.form
                elif isinstance(node, KFormDerivative):
                    node = node.form
                else:
                    break
        return tuple(out)


@dataclass(init=False, frozen=True, eq=False)
class KSum(TermEvaluatable):
    """Scaled sum of inner products and explicit terms sharing one weight."""

    pairs: tuple[tuple[float, KExplicit | KInnerProduct], ...]

    def __init__(self, *pairs: tuple[float, TermEvaluatable]) -> None:
        if len(pairs) < 1:
            raise TypeError("Can not create a sum object with no members.")
        weight: KWeight = pairs[0][1].weight
        new_pairs: list[tuple[float, KExplicit | KInnerProduct]] = []
        for coeff, term in pairs:
            if weight != term.weight:
                raise ValueError("Can not sum terms with varying weight forms")
            if type(term) is KSum:
                new_pairs.extend([(coeff * c, t) for c, t in term.pairs])
            else:
                if not isinstance(term, KExplicit) and type(term) is not KInnerProduct:
                    raise TypeError(
                        "Terms can only be sums, explicit, or inner products."
                    )
                new_pairs.append((coeff, term))
        object.__setattr__(self, "pairs", tuple(new_pairs))
        label = "(" + "+".join(ip.label for _, ip in new_pairs) + ")"
        super().__init__(label, weight)

    @property
    def unknowns(self) -> tuple[KFormUnknown, ...]:
        out: set[KFormUnknown] = set()
        for _, p in self.pairs:
            out |= set(p.unknowns)
        return tuple(out)

    @property
    def vector_fields(self) -> tuple:
        out: set = set()
        for _, p in self.pairs:
            out |= set(p.vector_fields)
        return tuple(out)

    @property
    def explicit_terms(self) -> tuple[tuple[float, KExplicit], ...]:
        return tuple((k, p) for k, p in self.pairs if isinstance(p, KExplicit))

    @property
    def implicit_terms(self) -> tuple[tuple[float, TermEvaluatable], ...]:
        return tuple((k, p) for k, p in self.pairs if not isinstance(p, KExplicit))

    def split_terms_linear_nonlinear(self) -> tuple[KSum | None, KSum | None]:
        """Split implicit terms into linear and nonlinear sums."""
        linear: list[tuple[float, KInnerProduct]] = []
        nonlin: list[tuple[float, KInnerProduct]] = []
        for c, v in self.pairs:
            if isinstance(v, KExplicit):
                continue
            assert type(v) is KInnerProduct
            if check_form_linear(v.unknown_form) and check_form_linear(v.weight_form):
                linear.append((c, v))
            else:
                nonlin.append((c, v))
        return (
            KSum(*linear) if linear else None,
            KSum(*nonlin) if nonlin else None,
        )


class TimeDependent:
    """Wrap a time-dependent function ``f(x, y, t)`` for use anywhere a
    steady ``f(x, y)`` is expected (forcing projections ``w @ f``, weak
    boundary terms ``w ^ f``).  During an unsteady solve the march sets
    :attr:`current_time` to the time level being solved for before
    re-evaluating the explicit vector, so sources and weak boundary data
    may vary in time (capability absent from the reference).
    """

    current_time: float = 0.0

    def __init__(self, func) -> None:
        self.func = func
        self.__name__ = getattr(func, "__name__", "time_dependent")

    def __call__(self, x, y):
        return self.func(x, y, type(self).current_time)


@dataclass(frozen=True)
class KExplicit(TermEvaluatable):
    """Base class for explicit (right-hand side) terms."""

    weight: KWeight
    func: Callable | None = None

    @property
    def unknowns(self) -> tuple[KFormUnknown, ...]:
        return tuple()

    @property
    def vector_fields(self) -> tuple:
        return tuple()


@dataclass(frozen=True)
class KElementProjection(KExplicit):
    """Element L2 projection of a forcing function (RHS term)."""


@dataclass(frozen=True)
class KBoundaryProjection(KExplicit):
    """Boundary integral of a function against the weight (weak BC term)."""


@dataclass(frozen=True)
class KEquation:
    """An equation: implicit LHS == (explicit + implicit) RHS."""

    left: KSum
    right: KSum

    def __post_init__(self) -> None:
        if len(self.left.explicit_terms):
            raise ValueError(
                "Explicit terms may not appear on the left side of the equation."
            )
        if self.left.weight != self.right.weight:
            raise ValueError(
                "Left and right side of the equation must use the exact same weight"
                " function."
            )

    @property
    def weight(self) -> KWeight:
        return self.left.weight
