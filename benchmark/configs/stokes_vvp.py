"""stokes_vvp's call into mfv2d_torch."""


def problem(config: dict, traffic: dict):
    """The keyword arguments of ``solve_system_2d`` for a mesh: the weak
    boundary conditions are in the system.  The model is built once, as a
    user sweeping a geometry would."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow

    model = flow.stokes_flow(with_divergence=False)
    system_settings = mf.SystemSettings(model.system)
    solver_settings = mf.SolverSettings(
        mf.ConvergenceSettings(
            config["maximum_iterations"],
            config["absolute_tolerance"],
            config["relative_tolerance"],
        ),
        linear_solver=traffic["linear_solver"],
    )

    def arguments(mesh) -> dict:
        return {
            "system_settings": system_settings,
            "solver_settings": solver_settings,
            "recon_order": traffic["recon_order"],
        }

    return arguments
