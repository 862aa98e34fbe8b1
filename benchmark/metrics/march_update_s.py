"""Seconds a march spends in its steps' update solves (the frozen host
triangular solves): the tracer stage ``march-step/picard-solve``."""


def read(run):
    return run.stage_seconds("march-step/picard-solve")
