"""The batched inverse of the port against the JAX package.

``gj_inverse`` runs its plain version (``gj_inverse_plain``,
``torch.linalg.inv``) on CPU tensors; the CUDA kernel is held against that
plain version on the card (``cuda``-marked test, and chip_smoke.py).  Here
the plain version is held against ``gj_inverse_pallas`` in interpret mode,
the refinement probe against the JAX one, and the mass inverses of the
element batches against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfv2d_torch import evaluation as tev
from mfv2d_torch.kform import UnknownFormOrder as TOrder
from mfv2d_torch.ops import precision as tprec
from mfv2d_torch.ops.basis import FemCache as TFemCache
from mfv2d_torch.ops.kernels import gj_inverse as kernel
from mfv2d_tpu import evaluation as jev
from mfv2d_tpu.kform import UnknownFormOrder as JOrder
from mfv2d_tpu.ops import precision as jprec
from mfv2d_tpu.ops.basis import FemCache
from mfv2d_tpu.ops.pallas_factor import gj_inverse_pallas

torch.set_num_threads(1)

BASE = np.array([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])


def rel(mine, ref) -> float:
    mine = mine.numpy() if isinstance(mine, torch.Tensor) else np.asarray(mine)
    return float(np.abs(mine - ref).max() / np.abs(ref).max())


def saddle_blocks(e, n_m, n_b, seed, zero_block_first=False):
    """``[[M, B^T], [B, 0]]`` with M SPD and B of full row rank; optionally
    ordered ``[[0, B], [B^T, M]]`` so the leading diagonal entries are zero."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(e, n_m, n_m))
    m = m @ m.transpose(0, 2, 1) + n_m * np.eye(n_m)
    b = rng.normal(size=(e, n_b, n_m))
    z = np.zeros((e, n_b, n_b))
    if zero_block_first:
        return np.block([[z, b], [b.transpose(0, 2, 1), m]])
    return np.block([[m, b.transpose(0, 2, 1)], [b, z]])


@pytest.mark.parametrize(
    "e, n, kw",
    [(8, 64, {}), (8, 289, {}), (4, 128, {"pivot_block": 128})],
    ids=["single-level", "padded-two-level", "masked-at-block"],
)
def test_plain_matches_gj_inverse_pallas(e, n, kw):
    """The cases of tests/test_pallas.py, in f32 as the TPU kernel runs."""
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(e, n, n)) + n * np.eye(n)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(gj_inverse_pallas(jnp.asarray(a), tile=4, **kw))
    mine = tprec.gj_inverse_plain(torch.tensor(a))
    assert mine.dtype == torch.float32
    assert rel(mine, ref) <= 5e-5


@pytest.mark.parametrize("zero_block_first", [False, True])
def test_plain_inverts_saddle_blocks(zero_block_first):
    a = saddle_blocks(6, 12, 5, seed=1, zero_block_first=zero_block_first)
    if zero_block_first:
        assert np.all(a[:, :5, :5] == 0.0)
    mine = kernel.gj_inverse(torch.tensor(a))
    assert rel(mine, np.linalg.inv(a)) <= 1e-12


@pytest.mark.parametrize("zero_block_first", [False, True])
def test_choose_refine_rounds_matches_jax(zero_block_first):
    a = saddle_blocks(6, 12, 5, seed=2, zero_block_first=zero_block_first)
    inv = np.linalg.inv(a)
    # An inverse perturbed to need refinement, besides the exact one.
    rough = inv * (1.0 + 1e-7 * np.random.default_rng(0).normal(size=inv.shape))
    for x in (inv, rough):
        jr, jerr = jprec.choose_refine_rounds(jnp.asarray(a), jnp.asarray(x))
        tr, terr = tprec.choose_refine_rounds(torch.tensor(a), torch.tensor(x))
        assert tr == jr
        assert max(terr, jerr) <= 1e-10  # both met the probe's target
    assert tprec.choose_refine_rounds(torch.tensor(a), torch.tensor(rough))[0] > 0


@pytest.mark.parametrize("orders", [(3, 3), (4, 2)])
def test_mass_inverse_matches_jax(orders):
    rng = np.random.default_rng(5)
    corners = np.tile(BASE, (7, 1, 1)) + 0.08 * rng.normal(size=(7, 4, 2))
    jbatch = jev.ElementBatch(FemCache(2).get_basis2d(*orders), corners)
    tbatch = tev.ElementBatch(TFemCache(2).get_basis2d(*orders), corners)
    for k in (0, 1, 2):
        mass = np.asarray(jbatch.mass(JOrder(k + 1), False))
        ref = np.asarray(jev._mass_inverse(jnp.asarray(mass)))
        mine = tev._mass_inverse(torch.tensor(mass))
        assert rel(mine, ref) <= 1e-12, k
        assert rel(tbatch.mass(TOrder(k + 1), True), ref) <= 1e-10, k


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.tensor(saddle_blocks(3, 4, 2, seed=4))
    with pytest.raises(TypeError, match="float32 or float64"):
        kernel.gj_inverse(a.to(torch.float16))
    with pytest.raises(TypeError, match="tensor"):
        kernel.gj_inverse(a.numpy())
    with pytest.raises(ValueError, match=r"\[E, n, n\]"):
        kernel.gj_inverse(a[0])
    with pytest.raises(ValueError, match=r"\[E, n, n\]"):
        kernel.gj_inverse(a[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gj_inverse(a.transpose(1, 2))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        kernel.gj_inverse(a.to("meta"))
    singular = a.clone()
    singular[1] = 0.0
    with pytest.raises(torch.linalg.LinAlgError):
        kernel.gj_inverse(singular)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    a = torch.tensor(saddle_blocks(5, 10, 3, seed=6))
    before = kernel.launches
    assert torch.equal(kernel.gj_inverse(a), tprec.gj_inverse_plain(a))
    batch = tev.ElementBatch(TFemCache(2).get_basis2d(3, 3), BASE[None])
    batch.mass(TOrder.FORM_ORDER_1, True)
    assert kernel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    for n_m, n_b in [(1, 0), (40, 16), (90, 31), (150, 58)]:
        a = torch.tensor(saddle_blocks(37, n_m, n_b, seed=n_m), device="cuda")
        a = a.to(dtype)
        before = kernel.launches
        out = kernel.gj_inverse(a)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert rel(out.cpu(), tprec.gj_inverse_plain(a).cpu().numpy()) <= tol
    singular = torch.zeros((2, 5, 5), dtype=dtype, device="cuda")
    with pytest.raises(torch.linalg.LinAlgError, match="matrix 0"):
        kernel.gj_inverse(singular)
