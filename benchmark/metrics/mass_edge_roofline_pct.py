"""M1's share of its roofline: the least time for the cell's 1-form mass
matrices (one batch of mesh^2 elements at the traffic's order and the
configuration's quadrature), over the device time of kernels whose name
holds ``mass_edge`` in one profiled warm solve."""

import roofline


def read(run):
    seconds = run.profile.kernel_seconds("mass_edge") if run.profile is not None else 0.0
    if not seconds:
        return None
    p = run.traffic["order"]
    nq = (p + 1 + run.config["over_integration"]) ** 2
    bound, _ = roofline.bound_s(*roofline.m1_work(run.traffic["mesh"] ** 2, p, nq))
    return 100 * bound / seconds
