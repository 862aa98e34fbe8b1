"""The port's unsteady gallery scripts (``examples_torch/unsteady``) against
the JAX package's (``examples/unsteady``) on the CPU: the same report titles
and values, and the point data of every grid of every march, to 1e-10
(direct solves).  ``unsteady_bc.py`` resumes its march from a checkpoint
and asserts the resumed error itself."""

import pytest
from gallery_harness import DIRECT_TOL, compare_grids, compare_reports, run_jax, run_port

SCRIPTS = [
    "unsteady/cavity_flow.py",
    "unsteady/forced_heat.py",
    "unsteady/heat_direct.py",
    "unsteady/heat_mixed.py",
    "unsteady/reaction.py",
    "unsteady/reaction_mixed.py",
    "unsteady/unsteady_bc.py",
    "unsteady/vector_reaction.py",
]


@pytest.mark.parametrize("rel", SCRIPTS)
def test_gallery_script_matches_jax(rel):
    jax_reports, jax_grids = run_jax(rel)
    port_reports, port_grids = run_port(rel)
    compare_reports(port_reports, jax_reports, DIRECT_TOL)
    compare_grids(port_grids, jax_grids, DIRECT_TOL)
