"""The port's explicit host-device copies, counted by the tracer.

Each helper makes the torch call its call sites made before it
(``torch.as_tensor``, or ``torch.tensor`` with ``copy``; ``.cpu().numpy()``),
with no pinning, no ``non_blocking`` and no added synchronisation.  While
the tracer is on it adds the bytes that crossed to the tracer's
``h2d_bytes`` or ``d2h_bytes``, only where the source's device type is not
the target's: on the CPU both stay 0.
"""

from __future__ import annotations

import numpy as np
import torch

from mfv2d_torch.tracing import tracer


def to_device(values, device, dtype: torch.dtype | None = None, *, copy: bool = False) -> torch.Tensor:
    """``values`` (a host array or a tensor) as a tensor of ``dtype`` on
    ``device``: ``torch.as_tensor``, or ``torch.tensor`` with ``copy``."""
    out = (torch.tensor if copy else torch.as_tensor)(values, dtype=dtype, device=device)
    if tracer.enabled:
        source = values.device.type if isinstance(values, torch.Tensor) else "cpu"
        if source != out.device.type:
            tracer.count("h2d_bytes", out.nbytes)
    return out


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor.cpu().numpy()``."""
    out = tensor.cpu().numpy()
    if tracer.enabled and tensor.device.type != "cpu":
        tracer.count("d2h_bytes", out.nbytes)
    return out
