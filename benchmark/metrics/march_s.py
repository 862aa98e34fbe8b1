"""Seconds a march spends in its steps: the tracer stage ``march-step``,
each step's residuals, update solve, carry and reconstruction."""


def read(run):
    return run.stage_seconds("march-step")
