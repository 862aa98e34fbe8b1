"""Seconds a solve spends condensing the element blocks onto the trace
(``G_e A_e^-1 G_e^T`` per element and its copy to the host) before the
trace SuperLU: the tracer stage ``picard-solve/schur-factor/condense``."""


def read(run):
    return run.stage_seconds("picard-solve/schur-factor/condense")
