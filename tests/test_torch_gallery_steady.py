"""The port's steady gallery scripts (``examples_torch/steady``) against the
JAX package's (``examples/steady``) on the CPU: the same report titles and
values, and every returned grid's point data, to 1e-10 (direct solves)."""

import pytest
from gallery_harness import DIRECT_TOL, compare_grids, compare_reports, run_jax, run_port

SCRIPTS = [
    "steady/direct_poisson.py",
    "steady/linear_adv_dif.py",
    "steady/mixed_poisson.py",
    "steady/navier_stokes.py",
    "steady/stokes_flow.py",
]


@pytest.mark.parametrize("rel", SCRIPTS)
def test_gallery_script_matches_jax(rel):
    jax_reports, jax_grids = run_jax(rel)
    port_reports, port_grids = run_port(rel)
    compare_reports(port_reports, jax_reports, DIRECT_TOL)
    compare_grids(port_grids, jax_grids, DIRECT_TOL)
