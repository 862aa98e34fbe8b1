"""The program tracer's host-device byte counters, per solve."""


def per_solve_gb(name: str) -> float | None:
    """The tracer's counter ``name`` over its ``solves``, in units of 1e9,
    or None where the tracer keeps no counters or counted no solve."""
    from mfv2d_torch.tracing import tracer

    total = getattr(tracer, "total", None)
    if total is None:
        return None
    solves = total("solves")
    return total(name) / 1e9 / solves if solves else None
