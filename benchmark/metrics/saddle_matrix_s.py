"""Seconds a solve spends building the direct route's sparse saddle matrix
(block diagonal, constraint blocks, CSC) before SuperLU: the tracer stage
``factorize/saddle-matrix``."""


def read(run):
    return run.stage_seconds("factorize/saddle-matrix")
