"""Transport model family: advection-diffusion, heat, and reaction marches.

Library versions of the reference examples (examples/steady/
plot_linear_adv_dif.py, examples/unsteady/plot_heat_*.py, plot_reaction*.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mfv2d_torch.kform import KFormUnknown, UnknownFormOrder
from mfv2d_torch.system import KFormSystem


@dataclass(frozen=True)
class TransportModel:
    """A transport problem: system, unknowns, and time-march relations."""

    system: KFormSystem
    u: KFormUnknown
    q: KFormUnknown | None = None
    time_march_relations: dict | None = None


def linear_advection_diffusion(nu: float, wind, u_bc, source) -> TransportModel:
    """Steady mixed advection-diffusion: nu lap(u) - a . grad(u) = -f.

    ``wind(x, y)`` is the advecting vector field; ``u_bc`` the weak Dirichlet
    data; ``source`` the forcing (reference plot_linear_adv_dif.py).
    """
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = KFormSystem(
        p.derivative @ u - p @ q == p ^ u_bc,
        nu * (v @ q.derivative) - (wind * v @ q) == -(v @ source),
    )
    return TransportModel(system, u, q)


def heat_direct(alpha: float, beta: float, steady_u) -> TransportModel:
    """Unsteady 0-form reaction-diffusion whose steady state is ``steady_u``.

    Exact solution: ``steady_u(x, y) * (1 - exp(-beta t))`` when the steady
    state satisfies ``lap(steady_u) = -(pi^2/2) steady_u`` (reference
    plot_heat_direct.py).
    """
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_0)
    v = u.weight
    system = KFormSystem(
        alpha * (v.derivative @ u.derivative)
        == beta * (v @ steady_u) - (beta - alpha * np.pi**2 / 2) * (v @ u),
    )
    return TransportModel(system, u, time_march_relations={v: u})


def heat_mixed(alpha: float, beta: float, steady_u) -> TransportModel:
    """Unsteady mixed (2-form) variant (reference plot_heat_mixed.py)."""
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = KFormSystem(
        p.derivative @ u - p @ q == p ^ steady_u,
        alpha * (v @ q.derivative)
        == beta * (v @ steady_u) - (beta - alpha * np.pi**2 / 2) * (v @ u),
        sorting=lambda f: f.order,
    )
    return TransportModel(system, u, q, time_march_relations={v: u})


def reaction(alpha: float, final_u, order=UnknownFormOrder.FORM_ORDER_0) -> TransportModel:
    """Pure reaction march du/dt = alpha (final_u - u) for a 0- or 1-form.

    Exact solution relaxes to ``final_u`` as ``1 - exp(-alpha t)``
    (reference plot_reaction.py / plot_vector_reaction.py).
    """
    u = KFormUnknown("u", order)
    v = u.weight
    if order == UnknownFormOrder.FORM_ORDER_0:
        q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
        p = q.weight
        system = KFormSystem(
            alpha * (v @ u) == alpha * (v @ final_u),
            p @ q - p @ u.derivative == 0,
            sorting=lambda f: f.order,
        )
        return TransportModel(system, u, q, time_march_relations={v: u})
    system = KFormSystem(
        alpha * (v @ u) == alpha * (v @ final_u),
        sorting=lambda f: f.order,
    )
    return TransportModel(system, u, time_march_relations={v: u})


def reaction_mixed(alpha: float, final_u) -> TransportModel:
    """2-form reaction march with flux extraction (plot_reaction_mixed.py)."""
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = KFormSystem(
        alpha * (v @ u) == alpha * (v @ final_u),
        p.derivative @ u - p @ q == p ^ final_u,
    )
    return TransportModel(system, u, q, time_march_relations={v: u})


def nonlinear_flow(nu: float, u_bc, source) -> TransportModel:
    """Nonlinear steady flow: ``nu lap(u) - q . grad(u) = -f`` with ``q``
    the unknown flux itself (a potential-flow Burgers equation).

    The advecting field is the solution's own gradient, so the advection
    term is quadratic in the unknowns and the solve is a Picard iteration
    — the scalar analogue of the Navier-Stokes momentum nonlinearity
    (reference nonlinear machinery: test_vms.py + plot_navier_stokes.py).
    For a manufactured ``u`` the source is
    ``|grad u|^2 - nu lap(u)`` (mirror linear_advection_diffusion with
    ``wind = grad u``).
    """
    u = KFormUnknown("u", UnknownFormOrder.FORM_ORDER_2)
    v = u.weight
    q = KFormUnknown("q", UnknownFormOrder.FORM_ORDER_1)
    p = q.weight
    system = KFormSystem(
        p.derivative @ u - p @ q == p ^ u_bc,
        nu * (v @ q.derivative) == (q * v @ q) - (v @ source),
    )
    return TransportModel(system, u, q)
