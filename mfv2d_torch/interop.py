"""Carrying state between the JAX package and the port.

The solver has no trained weights: its state is the mesh corners, the NumPy
basis tables and the DoF and multiplier vectors, which both packages hold as
NumPy arrays in the same global layout (solver/discretization.py).  The one
device-side object the packages exchange is the per-element geometry.  A
(refined) mesh crosses in the checkpoint format: ``mfv2d_torch.checkpoint.
mesh_from_arrays(mfv2d_tpu.checkpoint.mesh_to_arrays(mesh))``.
"""

from __future__ import annotations

import numpy as np
import torch

from mfv2d_torch.evaluation import check_device
from mfv2d_torch.ops.geometry import JacobianTerms


def jacobian_terms_from_numpy(j00, j01, j10, j11, det, device="cuda") -> JacobianTerms:
    """The port's ``JacobianTerms`` from NumPy arrays of the same terms.

    Each array is copied into a contiguous tensor of its own dtype on
    ``device``, the CUDA device unless the caller asks for ``"cpu"``.
    """
    device = check_device(device)
    return JacobianTerms(
        *(
            torch.tensor(np.asarray(v), device=device)
            for v in (j00, j01, j10, j11, det)
        )
    )
