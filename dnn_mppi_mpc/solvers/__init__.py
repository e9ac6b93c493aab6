from .cem import CEMConfig, CEMSolver, CEMState, cem_step  # noqa: F401
from .mppi import (  # noqa: F401
    MPPIAux,
    MPPISolver,
    MPPIState,
    make_rollout_kernel,
    make_tracking_costs,
    mppi_step,
    sampled_trajectories,
)
