"""Ready-made model systems (manufactured-solution problem families)."""

from mfv2d_torch.models import flow as flow
from mfv2d_torch.models import poisson as poisson
from mfv2d_torch.models import transport as transport
