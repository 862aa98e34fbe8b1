"""Bytes copied device to host a solve, in units of 1e9: the program
tracer's ``d2h_bytes`` over its ``solves``, read when the metric is read.
The tracer is reset at the window's start and is on in the window and in
the profiled solve, so both counts hold the same solves.  A program whose
tracer keeps no counters gives nothing."""

import crossings


def read(run):
    return crossings.per_solve_gb("d2h_bytes")
