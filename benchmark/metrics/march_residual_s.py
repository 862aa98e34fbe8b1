"""Seconds a march spends in its steps' Picard residuals (the stack machine
on the device): the tracer stage ``march-step/picard-residual``."""


def read(run):
    return run.stage_seconds("march-step/picard-residual")
