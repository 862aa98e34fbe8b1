"""Seconds a solve spends assembling the element matrices, forcing and
constraints: the tracer stage ``assembly+constraints``."""


def read(run):
    return run.stage_seconds("assembly+constraints")
