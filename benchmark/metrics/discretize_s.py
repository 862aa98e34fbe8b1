"""Seconds a solve spends in set-up (compiler, solver/discretization): the
program's tracer stage ``setup``."""


def read(run):
    return run.stage_seconds("setup")
