"""Discrete exterior-derivative (incidence) operators E10 and E21.

DoF layout convention (matches the reference, see forms.c:457-808 and
mimetic2d.py:33-391):

- 0-forms: ``(p1+1)(p2+1)`` nodal DoFs, index ``i2 * (p1+1) + i1``.
- 1-forms: first the "eta-component" block of ``p1 (p2+1)`` DoFs
  (edge-in-xi x node-in-eta, index ``i2 * p1 + i1``), then the
  "xi-component" block of ``(p1+1) p2`` DoFs (node-in-xi x edge-in-eta,
  index ``i2 * (p1+1) + i1``).
- 2-forms: ``p1 p2`` DoFs, index ``i2 * p1 + i1``.

Unlike the reference C evaluator (element_system.c:44-51, square orders only),
these are generalized to anisotropic ``(p1, p2)``.  The matrices are tiny
(p <= ~12), so they are applied as dense batched matmuls; no sparse structure is worth exploiting at this size.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def form_dof_counts(p1: int, p2: int) -> tuple[int, int, int]:
    """DoF counts of (0-form, 1-form, 2-form) on a (p1, p2) element."""
    return (
        (p1 + 1) * (p2 + 1),
        p1 * (p2 + 1) + (p1 + 1) * p2,
        p1 * p2,
    )


@lru_cache(maxsize=None)
def incidence_10(p1: int, p2: int) -> np.ndarray:
    """E10: discrete gradient mapping 0-form DoFs to 1-form DoFs.

    Sign convention matches mimetic2d.py:33-72: the eta-component rows are
    ``u[i2, i1] - u[i2, i1+1]`` and the xi-component rows are
    ``u[i2+1, i1] - u[i2, i1]``.
    """
    n0 = (p1 + 1) * (p2 + 1)
    n_h = p1 * (p2 + 1)
    n_v = (p1 + 1) * p2
    e = np.zeros((n_h + n_v, n0))
    for i2 in range(p2 + 1):
        for i1 in range(p1):
            r = i2 * p1 + i1
            e[r, i2 * (p1 + 1) + i1] = +1.0
            e[r, i2 * (p1 + 1) + i1 + 1] = -1.0
    for i2 in range(p2):
        for i1 in range(p1 + 1):
            r = n_h + i2 * (p1 + 1) + i1
            e[r, (i2 + 1) * (p1 + 1) + i1] = +1.0
            e[r, i2 * (p1 + 1) + i1] = -1.0
    e.setflags(write=False)
    return e


@lru_cache(maxsize=None)
def incidence_21(p1: int, p2: int) -> np.ndarray:
    """E21: discrete curl/divergence mapping 1-form DoFs to 2-form DoFs.

    Matches mimetic2d.py:215-251: ``s[i2,i1] = h[i2,i1] - h[i2+1,i1]
    + v[i2,i1] - v[i2,i1+1]``.
    """
    n_h = p1 * (p2 + 1)
    n_v = (p1 + 1) * p2
    n2 = p1 * p2
    e = np.zeros((n2, n_h + n_v))
    for i2 in range(p2):
        for i1 in range(p1):
            r = i2 * p1 + i1
            e[r, i2 * p1 + i1] = +1.0
            e[r, (i2 + 1) * p1 + i1] = -1.0
            e[r, n_h + i2 * (p1 + 1) + i1] = +1.0
            e[r, n_h + i2 * (p1 + 1) + i1 + 1] = -1.0
    e.setflags(write=False)
    return e


# Incidence "type" codes mirroring the reference C enum
# (incidence.h: E10=0, E21=1, E10^T=2, E21^T=3).
INCIDENCE_E10 = 0
INCIDENCE_E21 = 1
INCIDENCE_E10_T = 2
INCIDENCE_E21_T = 3


@lru_cache(maxsize=None)
def incidence_matrix(kind: int, p1: int, p2: int) -> np.ndarray:
    """Materialize the incidence matrix of the given kind."""
    if kind == INCIDENCE_E10:
        return incidence_10(p1, p2)
    if kind == INCIDENCE_E21:
        return incidence_21(p1, p2)
    if kind == INCIDENCE_E10_T:
        out = incidence_10(p1, p2).T.copy()
        out.setflags(write=False)
        return out
    if kind == INCIDENCE_E21_T:
        out = incidence_21(p1, p2).T.copy()
        out.setflags(write=False)
        return out
    raise ValueError(f"Invalid incidence kind {kind}.")


def apply_e10(p1: int, p2: int, other):
    """Left-multiply by E10 (reference mimetic2d.apply_e10)."""
    return incidence_10(p1, p2) @ np.asarray(other)


def apply_e10_t(p1: int, p2: int, other):
    """Left-multiply by E10 transposed."""
    return incidence_10(p1, p2).T @ np.asarray(other)


def apply_e10_r(p1: int, p2: int, other):
    """Right-multiply by E10."""
    return np.asarray(other) @ incidence_10(p1, p2)


def apply_e10_rt(p1: int, p2: int, other):
    """Right-multiply by E10 transposed."""
    return np.asarray(other) @ incidence_10(p1, p2).T


def apply_e21(p1: int, p2: int, other):
    """Left-multiply by E21."""
    return incidence_21(p1, p2) @ np.asarray(other)


def apply_e21_t(p1: int, p2: int, other):
    """Left-multiply by E21 transposed."""
    return incidence_21(p1, p2).T @ np.asarray(other)


def apply_e21_r(p1: int, p2: int, other):
    """Right-multiply by E21."""
    return np.asarray(other) @ incidence_21(p1, p2)


def apply_e21_rt(p1: int, p2: int, other):
    """Right-multiply by E21 transposed."""
    return np.asarray(other) @ incidence_21(p1, p2).T
