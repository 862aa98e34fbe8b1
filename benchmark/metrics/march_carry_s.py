"""Seconds a march spends projecting each step's state to its dual (a mass
apply per bucket, up and down) and updating the trapezoidal carry: the
tracer stage ``march-step/carry``."""


def read(run):
    return run.stage_seconds("march-step/carry")
