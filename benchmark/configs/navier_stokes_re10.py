"""navier_stokes_re10's call into mfv2d_torch."""


def problem(config: dict, traffic: dict):
    """The keyword arguments of ``solve_system_2d`` for a mesh: the strong
    velocity boundary condition is the mesh's own."""
    import mfv2d_torch as mf
    from mfv2d_torch.models import flow

    model = flow.navier_stokes(config["reynolds"])
    solver_settings = mf.SolverSettings(
        mf.ConvergenceSettings(
            config["maximum_iterations"],
            config["absolute_tolerance"],
            config["relative_tolerance"],
        ),
        relaxation=config["relaxation"],
        linear_solver=traffic["linear_solver"],
    )

    def arguments(mesh) -> dict:
        bc = mf.BoundaryCondition2DSteady(
            model.velocity, mesh.boundary_indices, flow.ns_velocity_exact
        )
        return {
            "system_settings": mf.SystemSettings(model.system, [bc], [(0.0, model.pressure)]),
            "solver_settings": solver_settings,
            "recon_order": traffic["recon_order"],
        }

    return arguments
