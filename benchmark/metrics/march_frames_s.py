"""Seconds a march spends reconstructing the grids of its sampled steps:
the tracer stage ``march-step/reconstruct`` (the initial state's grid is
made before the first step, at ``reconstruct``)."""


def read(run):
    return run.stage_seconds("march-step/reconstruct")
