"""System of k-form equations and the per-element form specification.

``ElementFormSpecification`` is the pure-Python equivalent of the reference's
C ``_ElementFormSpecification`` type (src/evaluation/forms.c:457-808): it maps
(form index, element orders) to DoF offsets/sizes inside the element vector.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator
from typing import Any, SupportsIndex

from mfv2d_torch.kform import KEquation, KForm, KFormUnknown, KWeight, UnknownFormOrder


class ElementFormSpecification:
    """Ordered list of (label, order) form specifications on an element."""

    __slots__ = ("_specs",)

    def __init__(self, *forms: KFormUnknown | tuple[str, int]) -> None:
        specs: list[tuple[str, UnknownFormOrder]] = []
        for form in forms:
            if isinstance(form, KFormUnknown):
                specs.append((form.label, UnknownFormOrder(form.order)))
            else:
                label, order = form
                specs.append((str(label), UnknownFormOrder(order)))
        labels = [s[0] for s in specs]
        if len(set(labels)) != len(labels):
            raise ValueError("Form labels must be unique.")
        self._specs = tuple(specs)

    @property
    def orders(self) -> tuple[UnknownFormOrder, ...]:
        return tuple(o for _, o in self._specs)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self._specs)

    def __iter__(self) -> Iterator[tuple[str, UnknownFormOrder]]:
        return iter(self._specs)

    def __getitem__(self, idx: SupportsIndex) -> tuple[str, UnknownFormOrder]:
        return self._specs[int(idx)]

    def __len__(self) -> int:
        return len(self._specs)

    def __contains__(self, item) -> bool:
        if isinstance(item, KFormUnknown):
            return (item.label, item.order) in self._specs
        label, order = item
        return (label, UnknownFormOrder(order)) in self._specs

    def get_form(self, idx: SupportsIndex, /) -> KFormUnknown:
        label, order = self[idx]
        return KFormUnknown(label, order)

    def iter_forms(self) -> Iterator[KFormUnknown]:
        for label, order in self._specs:
            yield KFormUnknown(label, order)

    def index(self, value) -> int:
        if isinstance(value, KFormUnknown):
            key = (value.label, value.order)
        else:
            key = (value[0], UnknownFormOrder(value[1]))
        return self._specs.index(key)

    def form_size(self, idx: SupportsIndex, /, order_1: int, order_2: int) -> int:
        return self._specs[int(idx)][1].full_unknown_count(order_1, order_2)

    def form_sizes(self, order_1: int, order_2: int) -> tuple[int, ...]:
        return tuple(
            o.full_unknown_count(order_1, order_2) for _, o in self._specs
        )

    def form_offset(self, idx: SupportsIndex, /, order_1: int, order_2: int) -> int:
        i = int(idx)
        return sum(
            o.full_unknown_count(order_1, order_2) for _, o in self._specs[:i]
        )

    def form_offsets(self, order_1: int, order_2: int) -> tuple[int, ...]:
        out = [0]
        for _, o in self._specs:
            out.append(out[-1] + o.full_unknown_count(order_1, order_2))
        return tuple(out)

    def total_size(self, order_1: int, order_2: int) -> int:
        return sum(o.full_unknown_count(order_1, order_2) for _, o in self._specs)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ElementFormSpecification):
            return NotImplemented
        return self._specs == other._specs

    def __hash__(self) -> int:
        return hash(self._specs)

    def __repr__(self) -> str:
        inner = ", ".join(f"({n!r}, {o.value})" for n, o in self._specs)
        return f"ElementFormSpecification({inner})"


class KFormSystem:
    """A system of k-form equations with unique weights per equation."""

    unknown_forms: ElementFormSpecification
    equations: tuple[KEquation, ...]
    weight_forms: tuple[KWeight, ...]

    def __init__(
        self,
        *equations: KEquation,
        sorting: Callable[[KForm], Any] | None = None,
    ) -> None:
        weights: list[KWeight] = []
        equation_list: list[KEquation] = []
        for ie, equation in enumerate(equations):
            weight = equation.weight
            if weight in weights:
                raise ValueError(
                    f"Weight form is not unique to the equation {ie}, as it already"
                    f" appears in equation {weights.index(weight)}."
                )
            weights.append(weight)
            equation_list.append(equation)

        if sorting is not None:
            self.weight_forms = tuple(sorted(weights, key=sorting))
        else:
            self.weight_forms = tuple(weights)

        self.unknown_forms = ElementFormSpecification(
            *(w.base_form for w in self.weight_forms)
        )
        self.equations = tuple(
            equation_list[weights.index(w)] for w in self.weight_forms
        )
