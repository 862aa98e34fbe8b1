"""Runtime configuration of the PyTorch port.

Only the two assembly settings the steady direct path reads are kept.  The
port runs in float64 by passing ``torch.float64`` explicitly; nothing here
changes torch's global default dtype.
"""

from __future__ import annotations

import os


class _Config:
    """Runtime configuration knobs."""

    def __init__(self) -> None:
        # Sum-factorized mass assembly (tensor-product splitting, ~5.5x
        # fewer flops at p=4): "auto" enables it from p=5 on, "always" /
        # "never" force it.
        self.sum_factorization = os.environ.get("MFV2D_TORCH_SUM_FACTOR", "auto")
        # Fused pair-table assembly: lower each linear-in-metric block to one
        # wide-N GEMM per term (ops/fused_assembly.py); disable with
        # MFV2D_TORCH_FUSED_ASSEMBLY=0 to force the stack machine everywhere.
        self.fused_assembly = (
            os.environ.get("MFV2D_TORCH_FUSED_ASSEMBLY", "1") != "0"
        )


config = _Config()
