"""Entries the trace SuperLU stores for L and U a solve, in millions: the
program tracer's ``trace_lu_nonzeros`` (SuperLU's ``nnz``, supernodal
padding included) over its ``solves``, read when the metric is read.  The
fill sets the trace factorization's time.  A program whose tracer keeps no
counters, or no such counter, gives nothing."""

import crossings


def read(run):
    per_solve = crossings.per_solve_gb("trace_lu_nonzeros")
    return 1e3 * per_solve if per_solve else None
