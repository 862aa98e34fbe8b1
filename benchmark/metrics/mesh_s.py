"""Seconds a solve spends building its mesh (``examples.unit_square_mesh``
and ``mesh/``): the benchmark's own span around each build."""


def read(run):
    return run.mesh_seconds / run.solves if run.solves else None
