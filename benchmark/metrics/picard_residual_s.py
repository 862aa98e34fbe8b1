"""Seconds a solve spends in Picard residuals (the stack machine on the
device): the tracer stage ``picard-residual``."""


def read(run):
    return run.stage_seconds("picard-residual")
