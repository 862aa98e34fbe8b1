"""The least time an H100 could take for a kernel's work: frozen counts.

The peaks are the H100 SXM data sheet's: HBM at 3.35 TB/s and the FP64
tensor cores at 67 TFLOP/s, at the full power limit of 700 W.  A
kernel's bound is the larger of its compulsory bytes over the first and
its least operations over the second.  The counts are functions of the
problem (element count, orders, quadrature points, block size), not of
the route or the launches that compute it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12
F64_BYTES = 8
# The Jacobian terms M1 reads at each quadrature point: j00, j01, j10, j11
# and the determinant.
JACOBIAN_TERMS = 5


def bound_s(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time (s) the card could take, and what bounds it."""
    bytes_s = n_bytes / HBM_BYTES_PER_S
    flops_s = n_flops / FP64_FLOP_PER_S
    return (bytes_s, "bytes") if bytes_s >= flops_s else (flops_s, "operations")


def form_dofs(form_order: int, p: int) -> int:
    """Degrees of freedom of a k-form on one element of order p."""
    return {0: (p + 1) ** 2, 1: 2 * p * (p + 1), 2: p * p}[form_order]


def m1_work(elements: int, p: int, nq: int) -> tuple[float, float]:
    """Bytes and operations of M1, the 1-form mass matrices of a batch.

    Every output entry is written once and every Jacobian term read once;
    by the symmetry of M1, n1 (n1 + 1) / 2 sums of nq products of two
    operations each.
    """
    n1 = form_dofs(1, p)
    n_bytes = (elements * n1 * n1 + JACOBIAN_TERMS * elements * nq) * F64_BYTES
    return n_bytes, elements * n1 * (n1 + 1) * nq


def inverse_work(elements: int, n: int) -> tuple[float, float]:
    """Bytes and operations of the inverses of ``elements`` blocks of n x n:
    each block read and its inverse written once, 2 n^3 operations."""
    return 2 * elements * n * n * F64_BYTES, 2 * n**3 * elements
