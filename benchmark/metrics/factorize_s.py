"""Seconds a solve spends setting up its linear solver (host SuperLU of the
saddle system, or the element inverses of the trace route): the tracer
span ``factorize``."""


def read(run):
    return run.stage_seconds("factorize")
