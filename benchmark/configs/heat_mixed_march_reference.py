"""heat_mixed_march's closed-form solution, in NumPy: the fields the last
grid of a march is held against.  Each function computes in the dtype of
its points.

The heat equation in mixed form, du/dt = beta s - (beta - alpha pi^2/2) u
- alpha div q with q = grad u and s = cos(pi x/2) cos(pi y/2), has s as its
steady state and, from u = 0, the solution u = (1 - e^(-beta t)) s.  The
program marches it by the trapezoidal rule: each step solves
(2/dt) M u_(n+1) + A x_(n+1) = F + (2/dt) M u_n + F - A x_n on the rows of
u, with the flux rows solved alongside.  The discrete steady state x_h
solves A x_h = F; on the rows of u, F = beta (v, s) is beta M u_h up to the
spatial error, and the flux rows' boundary term vanishes with s, so x_h is
an eigenvector of the marched operator with eigenvalue beta.  So the march
keeps x_n = f_n x_h with f_0 = 0 and
(f_(n+1) - f_n) / dt + beta (f_(n+1) + f_n) / 2 = beta, that is
1 - f_(n+1) = r (1 - f_n) with r = (1 - beta dt/2) / (1 + beta dt/2), and
after nt steps u = (1 - r^nt) s and q = (1 - r^nt) grad s, off only by the
spatial error.

The continuous form cannot serve: at dt = 0.125 the trapezoidal rule's own
error, (1 - r^16) against 1 - e^-2 (0.865018 against 0.864665), is 4e-4 of
the field, four orders above the float32 control, so no limit could tell a
float32 program from a float64 one.
"""

import json
from pathlib import Path

import numpy as np


def factor(beta: float, dt: float, nt: int) -> float:
    """1 - r^nt, the share of the steady state the march has reached."""
    r = (1 - beta * dt / 2) / (1 + beta * dt / 2)
    return 1.0 - r**nt


def fields(beta: float, t_end: float, nt: int) -> dict:
    """The fields after ``nt`` trapezoidal steps to ``t_end``."""
    f = factor(beta, t_end / nt, nt)

    def u(x, y):
        """(1 - r^nt) cos(pi x/2) cos(pi y/2)."""
        return f * np.cos(np.pi / 2 * x) * np.cos(np.pi / 2 * y)

    def q(x, y):
        """Its flux, the gradient of u, as (x, y) components."""
        return f * np.stack(
            (
                -np.pi / 2 * np.sin(np.pi / 2 * x) * np.cos(np.pi / 2 * y),
                -np.pi / 2 * np.cos(np.pi / 2 * x) * np.sin(np.pi / 2 * y),
            ),
            axis=-1,
        )

    return {"u": u, "q": q}


CONFIG = json.loads(Path(__file__).with_name("heat_mixed_march.json").read_text())
FIELDS = fields(CONFIG["beta"], CONFIG["t_end"], CONFIG["nt"])
