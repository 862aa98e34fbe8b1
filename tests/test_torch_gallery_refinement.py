"""The port's refinement gallery scripts (``examples_torch/refinement``)
against the JAX package's (``examples/refinement``) on the CPU: the same
report titles and values, and every returned grid's point data, to 1e-10
(direct solves).

``direct_poisson_refined.py`` is held to less, for two reasons:

- Its error is symmetric under the square's reflections (the bump is
  radial, and the linear part of u is resolved exactly), so mirror
  elements tie in every estimate.  Round-off breaks each tie one way in
  each package, and from round 1 on the two refine mirror images of one
  mesh: the errors, unknowns and leaves agree (to 1e-16), the point data
  do not.  Its grids are compared
  where no refinement has chosen yet, in the first round of each run.
- Its third run refines by ``ErrorEstimateLocalInverse(u, 1)`` a system
  whose element problem is singular (the 0-form u without strong forms:
  its local Neumann problem has the constants as null space), so both
  packages' estimates are round-off of 1e24 to 1e27, and which leaves
  each splits depends on its LAPACK (a reference fault, ROADMAP section
  3).  Its rounds after the first are held to their titles only.
"""

import pytest
from gallery_harness import DIRECT_TOL, compare_grids, compare_reports, run_jax, run_port

SCRIPTS = [
    "refinement/advdif_hp.py",
    # The JAX package takes about 35 s on it; its case at 3 rounds runs
    # in tier-1 (below).
    pytest.param("refinement/advdif_hp_projection.py", marks=pytest.mark.slow),
    "refinement/direct_poisson_refined.py",
    "refinement/poisson_hp_strategies.py",
]
# Per script: the report titles held to their titles only, and the
# solve_system_2d calls whose grids are compared (None: all).
HELD_TO_LESS = {
    "refinement/direct_poisson_refined.py": (
        {f"local_inverse round={i}" for i in (1, 2, 3)}, (0, 4, 8),
    ),
}


@pytest.mark.parametrize("rel", SCRIPTS)
def test_gallery_script_matches_jax(rel):
    titles_only, calls = HELD_TO_LESS.get(rel, ((), None))
    jax_reports, jax_grids = run_jax(rel)
    port_reports, port_grids = run_port(rel)
    compare_reports(port_reports, jax_reports, DIRECT_TOL, titles_only=titles_only)
    compare_grids(port_grids, jax_grids, DIRECT_TOL, calls=calls)


def _projection_three_rounds(module):
    """advdif_hp_projection.py's main with 3 refinement rounds a strategy
    in place of 6."""
    strategies = (("p-refine", 0.0), ("hp", 0.5), ("h-refine", 10.0))
    hist = [module.run_strategy(name, h_ratio, 10, 3) for name, h_ratio in strategies]
    module.report(
        "advdif_hp_projection final",
        p_err=hist[0][-1][1], hp_err=hist[1][-1][1], h_err=hist[2][-1][1],
    )


def test_advdif_hp_projection_at_three_rounds_matches_jax():
    rel = "refinement/advdif_hp_projection.py"
    jax_reports, jax_grids = run_jax(rel, call=_projection_three_rounds)
    port_reports, port_grids = run_port(rel, call=_projection_three_rounds)
    compare_reports(port_reports, jax_reports, DIRECT_TOL)
    compare_grids(port_grids, jax_grids, DIRECT_TOL)
