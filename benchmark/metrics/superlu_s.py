"""Seconds a solve spends in host SuperLU factorizations: the tracer
stages whose last part is ``superlu``, summed (``factorize/superlu`` on the
direct route, ``picard-solve/schur-factor/superlu`` on the trace route)."""


def read(run):
    keys = [k for k in run.stages if k.rsplit("/", 1)[-1] == "superlu"]
    if not keys or not run.solves:
        return None
    return sum(run.stages[k][1] for k in keys) / run.solves
