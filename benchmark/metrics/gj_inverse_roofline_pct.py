"""The element inverse's share of its roofline: the least time to invert
the cell's element blocks over the device time of kernels whose name holds
``gj_`` in one profiled warm solve.

It counts one inversion a solve of mesh^2 blocks of n, the DoFs of the
configuration's forms at the traffic's order: what ``"schur_direct"``
does in a steady solve with one Picard factorization.  A cell whose solve
inverts other blocks, or more sets of them (VMS inverts its Galerkin and
fine blocks as well), would read low here: it brings a reader of its own
and is not listed under this metric."""

import roofline


def read(run):
    seconds = run.profile.kernel_seconds("gj_") if run.profile is not None else 0.0
    if not seconds:
        return None
    p = run.traffic["order"]
    n = sum(roofline.form_dofs(k, p) for k in run.config["form_orders"])
    bound, _ = roofline.bound_s(*roofline.inverse_work(run.traffic["mesh"] ** 2, n))
    return 100 * bound / seconds
