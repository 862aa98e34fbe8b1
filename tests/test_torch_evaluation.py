"""Element matrices and vectors of the port against the JAX package.

Every block of ``compute_element_matrices`` and every row block of
``compute_element_vectors`` must agree to 1e-12 relative (to the block's
largest entry), for both assembly routes (fused pair tables and the stack
machine) and both sum-factorization settings.  The systems are the golden
compiler systems (mixed and direct Poisson, advection with a static field,
Navier-Stokes with a static and a DoF-dependent field) plus Stokes.
"""

import sys
from contextlib import contextmanager
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfv2d_torch.compiler as tcompiler
import mfv2d_torch.evaluation as tevaluation
import mfv2d_torch.kform as tkform
import mfv2d_torch.system as tsystem
import mfv2d_tpu.compiler as jcompiler
import mfv2d_tpu.evaluation as jevaluation
import mfv2d_tpu.kform as jkform
import mfv2d_tpu.system as jsystem
from mfv2d_torch.config import config as tconfig
from mfv2d_torch.models import flow as tflow
from mfv2d_torch.ops.basis import FemCache as TFemCache
from mfv2d_tpu.config import config as jconfig
from mfv2d_tpu.models import flow as jflow
from mfv2d_tpu.ops.basis import FemCache as JFemCache

sys.path.insert(0, str(Path(__file__).parent / "golden"))
try:
    from make_compiler_fixtures import build_systems
finally:
    sys.path.pop(0)

torch.set_num_threads(1)

ORDERS = (3, 4)
BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])


def _systems(kform, system_mod, flow):
    out = dict(build_systems(kform, system_mod))
    out["stokes"] = lambda: flow.stokes_flow().system
    return out


SYSTEMS = ["mixed_poisson", "direct_poisson", "advection", "navier_stokes", "stokes"]


@contextmanager
def settings(fused, sum_factorization):
    old = (
        jconfig.fused_assembly,
        tconfig.fused_assembly,
        jconfig.sum_factorization,
        tconfig.sum_factorization,
    )
    jconfig.fused_assembly = tconfig.fused_assembly = fused
    jconfig.sum_factorization = tconfig.sum_factorization = sum_factorization
    try:
        yield
    finally:
        (
            jconfig.fused_assembly,
            tconfig.fused_assembly,
            jconfig.sum_factorization,
            tconfig.sum_factorization,
        ) = old


def _block_rel(mine, ref) -> float:
    scale = float(np.abs(ref).max())
    diff = float(np.abs(mine - ref).max())
    return diff if scale == 0.0 else diff / scale


def _setup(name):
    jsys = _systems(jkform, jsystem, jflow)[name]()
    tsys = _systems(tkform, tsystem, tflow)[name]()
    jcomp = jcompiler.CompiledSystem(jsys)
    tcomp = tcompiler.CompiledSystem(tsys)
    rng = np.random.default_rng(len(name))
    e = 5
    corners = np.tile(BASE, (e, 1, 1)) + 0.08 * rng.normal(size=(e, 4, 2))
    jbatch = jevaluation.ElementBatch(JFemCache(3).get_basis2d(*ORDERS), corners)
    tbatch = tevaluation.ElementBatch(TFemCache(3).get_basis2d(*ORDERS), corners, "cpu")
    n = jsys.unknown_forms.total_size(*ORDERS)
    dofs = rng.normal(size=(e, n))
    jstat = jevaluation.evaluate_static_fields(jbatch, jcomp.fields)
    tstat = tevaluation.evaluate_static_fields(tbatch, tcomp.fields)
    return jsys, tsys, jcomp, tcomp, jbatch, tbatch, dofs, jstat, tstat


@pytest.mark.parametrize("sum_factorization", ["never", "always"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "stack"])
@pytest.mark.parametrize("name", SYSTEMS)
def test_element_matrices_and_vectors_match_jax(name, fused, sum_factorization):
    jsys, tsys, jcomp, tcomp, jbatch, tbatch, dofs, jstat, tstat = _setup(name)
    offsets = jsys.unknown_forms.form_offsets(*ORDERS)
    assert offsets == tsys.unknown_forms.form_offsets(*ORDERS)
    tdofs = torch.tensor(dofs)
    which = [("lhs", jcomp.lhs_blocks, tcomp.lhs_blocks)]
    if jcomp.rhs_blocks is not None:
        which.append(("rhs", jcomp.rhs_blocks, tcomp.rhs_blocks))
    with settings(fused, sum_factorization):
        for label, jblocks, tblocks in which:
            ref = np.asarray(
                jevaluation.compute_element_matrices(
                    jsys.unknown_forms, jblocks, jbatch, jnp.asarray(dofs), jstat
                )
            )
            mine = tevaluation.compute_element_matrices(
                tsys.unknown_forms, tblocks, tbatch, tdofs, tstat
            )
            assert mine.dtype == torch.float64 and mine.shape == ref.shape
            mine = mine.numpy()
            for i in range(len(offsets) - 1):
                for j in range(len(offsets) - 1):
                    rows = slice(offsets[i], offsets[i + 1])
                    cols = slice(offsets[j], offsets[j + 1])
                    err = _block_rel(mine[:, rows, cols], ref[:, rows, cols])
                    assert err <= 1e-12, (label, i, j, err)

            ref = np.asarray(
                jevaluation.compute_element_vectors(
                    jsys.unknown_forms, jblocks, jbatch, jnp.asarray(dofs), jstat
                )
            )
            mine = tevaluation.compute_element_vectors(
                tsys.unknown_forms, tblocks, tbatch, tdofs, tstat
            ).numpy()
            for i in range(len(offsets) - 1):
                rows = slice(offsets[i], offsets[i + 1])
                err = _block_rel(mine[:, rows], ref[:, rows])
                assert err <= 1e-12, (label, i, err)


def test_unknown_field_needs_dofs():
    _, tsys, _, tcomp, _, tbatch, _, _, tstat = _setup("navier_stokes")
    with pytest.raises(ValueError, match="unknown form"):
        tevaluation.compute_element_matrices(
            tsys.unknown_forms, tcomp.rhs_blocks, tbatch, None, tstat
        )


def test_apply_mass_inverts():
    _, tsys, _, _, _, tbatch, dofs, _, _ = _setup("stokes")
    x = torch.tensor(dofs)
    y = tevaluation.apply_mass(tsys.unknown_forms, tbatch, x, inverse=False)
    back = tevaluation.apply_mass(tsys.unknown_forms, tbatch, y, inverse=True)
    assert torch.allclose(back, x, atol=1e-10)


def _mesh_integrand(x, y):
    return x * y + x**2 + np.sin(3 * y)


@pytest.mark.parametrize("orders", [None, 6, 2], ids=["mesh-orders", "orders-6", "orders-2"])
@pytest.mark.parametrize("shape", [(4, 4, 3), (3, 5, 2)], ids=["4x4-p3", "3x5-p2"])
def test_integrate_over_elements_matches_jax(shape, orders):
    """Per-element integrals (mirrors tests/test_mesh.py's
    test_integrate_over_elements) agree with the JAX package's to 1e-14
    relative, and the total is the integral over the unit square."""
    import mfv2d_torch as tf
    import mfv2d_tpu as jf
    from mfv2d_torch.mimetic import integrate_over_elements as tintegrate
    from mfv2d_tpu.mimetic import integrate_over_elements as jintegrate

    ref = np.asarray(jintegrate(jf.examples.unit_square_mesh(*shape), _mesh_integrand, orders))
    mine = tintegrate(tf.examples.unit_square_mesh(*shape), _mesh_integrand, orders)
    assert mine.shape == ref.shape == (shape[0] * shape[1],)
    np.testing.assert_allclose(mine, ref, rtol=1e-14, atol=1e-14 * np.abs(ref).max())
    # Over [-1, 1]^2: xy integrates to 0, x^2 to 4/3, sin(3y) to 0.
    if orders != 2:
        assert abs(mine.sum() - 4.0 / 3.0) <= 1e-12
