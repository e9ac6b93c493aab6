"""Vehicle dynamics as pure, batched JAX functions ``f(x, u, params) -> xdot``.

Every model is written in terms of ``x[..., i]`` so it broadcasts over arbitrary
leading batch dimensions (K samples, scenario batches, shooting nodes) without
``vmap`` — the batched replacement for the reference's scalar models:

* unicycle / differential drive  — controllers/mppi_differential_drive.py:182-198,
  models/differentialSim.py:105-141
* kinematic bicycle              — controllers/mppi_race_car_obstacle.py:200-214,
  models/raceCarSim.py:38-65 (continuous form)
* four-wheel torque-input model  — controllers/mpc_differential_dynamics.py:98-105
* dynamic bicycle w/ tire slip   — controllers/mpc_racecar_class.py:34-44

All functions return the continuous-time derivative; discretization lives in
:mod:`dnn_mppi_mpc.models.integrators`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

Dynamics = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def unicycle(x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Differential-drive / unicycle kinematics.

    State (x, y, yaw); control (v, ω).
    Continuous form of controllers/mppi_differential_drive.py:182-198 and
    the acados model at controllers/mpc_differential_drive_obstacle_static.py:38-42.
    """
    yaw = x[..., 2]
    v, w = u[..., 0], u[..., 1]
    return jnp.stack([v * jnp.cos(yaw), v * jnp.sin(yaw), w], axis=-1)


@register_pytree_node_class
@dataclasses.dataclass
class BicycleParams:
    """Kinematic-bicycle wheelbase. Race car L=0.325 (mpc_racecar.py:25) or the
    MPPI race car L=2.5 (mppi_race_car_obstacle.py:14)."""

    wheel_base: jnp.ndarray

    def tree_flatten(self):
        return (self.wheel_base,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def kinematic_bicycle(
    x: jnp.ndarray, u: jnp.ndarray, params: Optional[BicycleParams] = None
) -> jnp.ndarray:
    """Kinematic bicycle: state (x, y, yaw, v); control (steer δ, accel a).

    Continuous form of the Euler update at controllers/mppi_race_car_obstacle.py:200-214
    (ẋ = v cos ψ, ẏ = v sin ψ, ψ̇ = v tan δ / L, v̇ = a) and models/raceCarSim.py:38-65.
    """
    L = params.wheel_base if params is not None else 2.5
    yaw, v = x[..., 2], x[..., 3]
    steer, accel = u[..., 0], u[..., 1]
    return jnp.stack(
        [
            v * jnp.cos(yaw),
            v * jnp.sin(yaw),
            v * jnp.tan(steer) / L,
            accel,
        ],
        axis=-1,
    )


@register_pytree_node_class
@dataclasses.dataclass
class FourWheelParams:
    """Four-wheel torque-input model parameters.

    Defaults from controllers/mpc_differential_dynamics.py:72-77
    (m=2.0, I=2.0296, r=0.17775, L=0.5708).
    """

    mass: jnp.ndarray
    inertia: jnp.ndarray
    wheel_radius: jnp.ndarray
    wheel_sep: jnp.ndarray

    def tree_flatten(self):
        return (self.mass, self.inertia, self.wheel_radius, self.wheel_sep), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def default(cls) -> "FourWheelParams":
        return cls(
            mass=jnp.asarray(2.0),
            inertia=jnp.asarray(2.0296),
            wheel_radius=jnp.asarray(0.17775),
            wheel_sep=jnp.asarray(0.5708),
        )


def four_wheel_torque(
    x: jnp.ndarray, u: jnp.ndarray, params: Optional[FourWheelParams] = None
) -> jnp.ndarray:
    """Four-wheel dynamic model, wheel torques as inputs.

    State (x, y, θ, v, ω); control (τ_fr, τ_fl, τ_rr, τ_rl).
    Continuous dynamics from controllers/mpc_differential_dynamics.py:98-105:
      v̇ = r/(4m) Στ;  ω̇ = r/(L·I) · ((τ_fr+τ_rr) − (τ_fl+τ_rl))/2.
    """
    if params is None:
        params = FourWheelParams.default()
    theta, v, omega = x[..., 2], x[..., 3], x[..., 4]
    t_fr, t_fl, t_rr, t_rl = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    r, m = params.wheel_radius, params.mass
    L, inertia = params.wheel_sep, params.inertia
    dv = (r / (4.0 * m)) * (t_fr + t_fl + t_rr + t_rl)
    domega = (r / (L * inertia)) * ((t_fr + t_rr) - (t_fl + t_rl)) / 2.0
    return jnp.stack(
        [v * jnp.cos(theta), v * jnp.sin(theta), omega, dv, domega], axis=-1
    )


@register_pytree_node_class
@dataclasses.dataclass
class DynamicBicycleParams:
    """Dynamic single-track model parameters with linear-ish tire forces.

    Defaults from controllers/mpc_racecar_class.py:25-32
    (L=0.325, m=4.0, Iz=0.05865, Cf=Cr=1000, lf=lr=L/2).
    """

    mass: jnp.ndarray
    inertia_z: jnp.ndarray
    cornering_front: jnp.ndarray
    cornering_rear: jnp.ndarray
    lf: jnp.ndarray
    lr: jnp.ndarray

    def tree_flatten(self):
        return (
            self.mass,
            self.inertia_z,
            self.cornering_front,
            self.cornering_rear,
            self.lf,
            self.lr,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def default(cls) -> "DynamicBicycleParams":
        return cls(
            mass=jnp.asarray(4.0),
            inertia_z=jnp.asarray(0.05865),
            cornering_front=jnp.asarray(1000.0),
            cornering_rear=jnp.asarray(1000.0),
            lf=jnp.asarray(0.325 / 2),
            lr=jnp.asarray(0.325 / 2),
        )


def dynamic_bicycle(
    x: jnp.ndarray, u: jnp.ndarray, params: Optional[DynamicBicycleParams] = None
) -> jnp.ndarray:
    """Dynamic bicycle with sideslip β and lateral tire forces.

    State (x, y, yaw, v); control (a, δ) — same layout as
    controllers/mpc_racecar_class.py:34-44:
      β  = atan(lr/(lf+lr) · tan δ)
      f_y = 2·(Cf sin(atan((v sinβ + lf·yaw)/(v cosβ))) cos δ
             + Cr sin(atan((v sinβ − lr·yaw)/(v cosβ))))
      ẋ = v cos(yaw+β), ẏ = v sin(yaw+β), ψ̇ = v sinβ/lr, v̇ = (a − f_y sin δ)/m.

    A small epsilon guards v·cosβ ≈ 0 so the compiled graph is NaN-free at rest
    (the reference relies on CasADi evaluating away from v=0).
    """
    if params is None:
        params = DynamicBicycleParams.default()
    yaw, v = x[..., 2], x[..., 3]
    a, steer = u[..., 0], u[..., 1]
    lf, lr = params.lf, params.lr
    beta = jnp.arctan(lr / (lf + lr) * jnp.tan(steer))
    vx = v * jnp.cos(beta)
    vx_safe = jnp.where(jnp.abs(vx) < 1e-6, 1e-6, vx)
    fy = 2.0 * (
        params.cornering_front
        * jnp.sin(jnp.arctan((v * jnp.sin(beta) + lf * yaw) / vx_safe))
        * jnp.cos(steer)
        + params.cornering_rear
        * jnp.sin(jnp.arctan((v * jnp.sin(beta) - lr * yaw) / vx_safe))
    )
    return jnp.stack(
        [
            v * jnp.cos(yaw + beta),
            v * jnp.sin(yaw + beta),
            v * jnp.sin(beta) / lr,
            (a - fy * jnp.sin(steer)) / params.mass,
        ],
        axis=-1,
    )


def residual_dynamics(
    analytic: Dynamics, learned: Callable[[jnp.ndarray], jnp.ndarray]
) -> Dynamics:
    """Compose analytic dynamics with a learned residual: f = f_a(x,u) + NN(·).

    JAX replacement for the l4casadi path
    (simulation/bullet_differential_drive_dnn.py:88-92, f_expl = unicycle + residual):
    the network is an ordinary JAX function so Jacobians/Hessians come from
    jax.jacfwd/jax.hessian instead of TorchScript traces (_l4c_generated/*).
    ``learned`` receives the concatenated (x, u) features.
    """

    def f(x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        feats = jnp.concatenate([x, u], axis=-1)
        return analytic(x, u) + learned(feats)

    return f


__all__ = [
    "Dynamics",
    "unicycle",
    "BicycleParams",
    "kinematic_bicycle",
    "FourWheelParams",
    "four_wheel_torque",
    "DynamicBicycleParams",
    "dynamic_bicycle",
    "residual_dynamics",
]
