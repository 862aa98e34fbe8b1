"""What the f64 explicit-inverse branch of the element-block solvers needs.

The JAX package keeps explicit element inverses because the TPU has no f64
LU: it seeds them in f32 (``blocked_gj_inverse``, ``gj_inverse_pallas``),
repairs them by Newton-Schulz, and probes how many residual refinement
rounds an apply needs (mfv2d_tpu/ops/precision.py).  On the H100 the
pivoted Gauss-Jordan kernel (:mod:`mfv2d_torch.ops.kernels.gj_inverse`)
builds the f64 inverse directly, so only the probe is carried over.
"""

from __future__ import annotations

import numpy as np
import torch


def gj_inverse_plain(a: torch.Tensor) -> torch.Tensor:
    """Batched ``[E, n, n]`` inverse: the plain version of the kernel."""
    return torch.linalg.inv(a)


def choose_refine_rounds(
    blocks: torch.Tensor,
    inverse: torch.Tensor,
    *,
    target: float = 1e-10,
    max_rounds: int = 6,
) -> tuple[int, float]:
    """Residual-refinement rounds needed for ``inverse`` to solve to ``target``.

    The explicit inverse applies to ``~cond(A) * eps_f64`` relative error;
    each refinement round (one residual + one correction GEMV) contracts by
    that factor again.  Probes with the ones vector and returns the smallest
    round count whose probe error meets ``target`` (normally 0), plus the
    achieved error; the caller decides whether a shortfall means the blocks
    are singular.
    """
    probe = torch.ones(blocks.shape[:-1], dtype=blocks.dtype, device=blocks.device)
    applied = torch.einsum("...ij,...j->...i", blocks, probe)
    err = float("inf")
    for rounds in range(max_rounds + 1):
        x = torch.einsum("...ij,...j->...i", inverse, applied)
        for _ in range(rounds):
            r = applied - torch.einsum("...ij,...j->...i", blocks, x)
            x = x + torch.einsum("...ij,...j->...i", inverse, r)
        err = float((x - 1.0).abs().max())
        if np.isfinite(err) and err <= target:
            return rounds, err
    return max_rounds, err
