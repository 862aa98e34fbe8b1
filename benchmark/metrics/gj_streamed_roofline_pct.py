"""The element inverse's share of its roofline on the streamed route: the
least time to invert the cell's element blocks over the device time of
kernels whose name holds ``gj_streamed`` (panel, tile update and unswap) in
one profiled warm solve.

It counts one inversion a solve of mesh^2 blocks of n, the DoFs of the
configuration's forms at the traffic's order: what ``"schur_direct"``
does in a linear steady solve, which factors once.  A cell whose blocks
take another route reads nothing here."""

import roofline


def read(run):
    seconds = run.profile.kernel_seconds("gj_streamed") if run.profile is not None else 0.0
    if not seconds:
        return None
    p = run.traffic["order"]
    n = sum(roofline.form_dofs(k, p) for k in run.config["form_orders"])
    bound, _ = roofline.bound_s(*roofline.inverse_work(run.traffic["mesh"] ** 2, n))
    return 100 * bound / seconds
