"""mixed_poisson's call into mfv2d_torch."""


def problem(config: dict, traffic: dict):
    """The keyword arguments of ``solve_system_2d`` for a mesh.  The model
    is built once, as a user sweeping a geometry would."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import poisson

    model = poisson.mixed_poisson()
    system_settings = mf.SystemSettings(model.system)
    solver_settings = mf.SolverSettings(linear_solver=traffic["linear_solver"])

    def arguments(mesh) -> dict:
        return {
            "system_settings": system_settings,
            "solver_settings": solver_settings,
            "recon_order": traffic["recon_order"],
        }

    return arguments
