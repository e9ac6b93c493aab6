from .dynamics import (  # noqa: F401
    BicycleParams,
    DynamicBicycleParams,
    FourWheelParams,
    dynamic_bicycle,
    four_wheel_torque,
    kinematic_bicycle,
    residual_dynamics,
    unicycle,
)
from .integrators import discretize, erk_step, euler_step, rk4_step, rollout  # noqa: F401
from .tile import (  # noqa: F401
    dynamic_bicycle_tile,
    four_wheel_torque_tile,
    kinematic_bicycle_tile,
    unicycle_tile,
)
