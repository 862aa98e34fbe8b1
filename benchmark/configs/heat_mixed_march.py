"""heat_mixed_march's call into mfv2d_torch."""

import numpy as np


def steady_u(x, y):
    """The steady state s = cos(pi x/2) cos(pi y/2) the march relaxes to."""
    return np.cos(np.pi * x / 2) * np.cos(np.pi * y / 2)


def problem(config: dict, traffic: dict):
    """The keyword arguments of ``solve_system_2d`` for a mesh: a
    trapezoidal march of ``nt`` steps from zero.  The model is built once,
    as a user sweeping a geometry would."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import transport

    model = transport.heat_mixed(config["alpha"], config["beta"], steady_u)
    system_settings = mf.SystemSettings(model.system)
    solver_settings = mf.SolverSettings(
        mf.ConvergenceSettings(
            config["maximum_iterations"],
            config["absolute_tolerance"],
            config["relative_tolerance"],
        ),
        linear_solver=traffic["linear_solver"],
    )
    time_settings = mf.TimeSettings(
        dt=config["t_end"] / config["nt"],
        nt=config["nt"],
        time_march_relations=model.time_march_relations,
        sample_rate=config["sample_rate"],
    )

    def arguments(mesh) -> dict:
        return {
            "system_settings": system_settings,
            "solver_settings": solver_settings,
            "time_settings": time_settings,
            "recon_order": traffic["recon_order"],
        }

    return arguments
