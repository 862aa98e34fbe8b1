"""Seconds a solve spends in its update solves: the tracer stage
``picard-solve``, with the stages nested in it (the trace SuperLU of
``schur_direct``, ``picard-solve/schur-factor``, among them)."""


def read(run):
    return run.stage_seconds("picard-solve")
