"""Incompressible flow model family: Stokes and Navier-Stokes.

Vorticity-velocity-pressure (VVP) mimetic formulations matching the
reference examples (examples/steady/plot_stokes_flow.py,
plot_navier_stokes.py, examples/unsteady/plot_cavity_flow.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mfv2d_torch.kform import KFormUnknown, UnknownFormOrder
from mfv2d_torch.system import KFormSystem


@dataclass(frozen=True)
class FlowModel:
    """A flow problem: system plus its unknown forms."""

    system: KFormSystem
    vorticity: KFormUnknown
    velocity: KFormUnknown
    pressure: KFormUnknown
    divergence: KFormUnknown | None = None
    time_march_relations: dict | None = None


# -- Stokes (manufactured solution) -----------------------------------------


def stokes_velocity_exact(x, y):
    """Divergence-free manufactured velocity (reference plot_stokes_flow.py)."""
    return np.stack((np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)), axis=-1)


def stokes_pressure_exact(x, y):
    return 0 * x * y


def stokes_vorticity_exact(x, y):
    return -2 * np.sin(x) * np.sin(y) + 0 * x * y


def stokes_momentum_source(x, y):
    """Momentum source for the manufactured fields."""
    return -2 * np.stack((np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y)), axis=-1)


def stokes_flow(with_divergence: bool = True) -> FlowModel:
    """Steady Stokes flow in VVP form with weak velocity/pressure BCs."""
    prs = KFormUnknown("prs", UnknownFormOrder.FORM_ORDER_2)
    w_prs = prs.weight
    vel = KFormUnknown("vel", UnknownFormOrder.FORM_ORDER_1)
    w_vel = vel.weight
    vor = KFormUnknown("vor", UnknownFormOrder.FORM_ORDER_0)
    w_vor = vor.weight

    equations = [
        w_vor.derivative @ vel + w_vor @ vor == w_vor ^ stokes_velocity_exact,
        w_vel @ vor.derivative + w_vel.derivative @ prs
        == (w_vel ^ stokes_pressure_exact) + w_vel @ stokes_momentum_source,
        w_prs @ vel.derivative == 0,
    ]
    div = None
    if with_divergence:
        div = KFormUnknown("div", UnknownFormOrder.FORM_ORDER_2)
        w_div = div.weight
        equations.append(w_div @ div - w_div @ vel.derivative == 0)
    return FlowModel(KFormSystem(*equations), vor, vel, prs, div)


# -- Navier-Stokes ----------------------------------------------------------


def ns_velocity_exact(x, y):
    return np.stack((np.sin(y) + 0 * x, np.cos(x) + 0 * y), axis=-1)


def ns_vorticity_exact(x, y):
    return -(np.sin(x) + np.cos(y))


def make_ns_forcing(reynolds: float):
    """Momentum forcing for the manufactured NS solution at a Reynolds number."""

    def forcing(x, y):
        return np.stack(
            (
                np.cos(x) * np.cos(y) + 1 / reynolds * np.sin(y),
                -np.sin(x) * np.sin(y) + 1 / reynolds * np.cos(x),
            ),
            axis=-1,
        )

    return forcing


def navier_stokes(reynolds: float) -> FlowModel:
    """Steady NS in VVP form with nonlinear advection on the RHS.

    Pair with a strong velocity BC and the constrained pressure
    ``[(0.0, model.pressure)]`` (reference plot_navier_stokes.py).
    """
    pre = KFormUnknown("pre", UnknownFormOrder.FORM_ORDER_2)
    w_pre = pre.weight
    vel = KFormUnknown("vel", UnknownFormOrder.FORM_ORDER_1)
    w_vel = vel.weight
    vor = KFormUnknown("vor", UnknownFormOrder.FORM_ORDER_0)
    w_vor = vor.weight
    forcing = make_ns_forcing(reynolds)

    system = KFormSystem(
        w_vor.derivative @ vel - w_vor @ vor == w_vor ^ ns_velocity_exact,
        (1 / reynolds) * (w_vel @ vor.derivative) + w_vel.derivative @ pre
        == w_vel @ forcing - (vel * w_vel @ vor),
        (w_pre @ vel.derivative) == 0,
    )
    return FlowModel(system, vor, vel, pre)


def cavity_flow(reynolds: float, lid_velocity) -> FlowModel:
    """Lid-driven cavity (unsteady NS): weak vorticity BC from the lid.

    ``lid_velocity(x, y)`` gives the boundary velocity; march the velocity
    equation with ``TimeSettings(..., time_march_relations={w_vel: vel})``
    (reference plot_cavity_flow.py).
    """
    pre = KFormUnknown("pre", UnknownFormOrder.FORM_ORDER_2)
    w_pre = pre.weight
    vel = KFormUnknown("vel", UnknownFormOrder.FORM_ORDER_1)
    w_vel = vel.weight
    vor = KFormUnknown("vor", UnknownFormOrder.FORM_ORDER_0)
    w_vor = vor.weight

    system = KFormSystem(
        w_vor.derivative @ vel - w_vor @ vor == w_vor ^ lid_velocity,
        (1 / reynolds) * (w_vel @ vor.derivative) + w_vel.derivative @ pre
        == -(vel * w_vel @ vor),
        w_pre @ vel.derivative == 0,
    )
    return FlowModel(system, vor, vel, pre, time_march_relations={w_vel: vel})
