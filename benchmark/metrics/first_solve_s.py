"""Seconds of the process's first ``solve_system_2d`` call, cold: plans
built, tables uploaded, first launches; imports and CUDA excluded.  It is
part of ``setup_s``; what the per-process caches save shows as its gap to
a warm solve."""


def read(run):
    return run.first_solve_s
