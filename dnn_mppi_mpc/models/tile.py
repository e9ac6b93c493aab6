"""Tile-form discrete dynamics for the GPU rollout kernel.

A *tile step* operates elementwise on ``(block_k,)`` sample vectors — one
array per state/control dimension — so it can be traced into the rollout
kernel (ops/pallas/rollout.py) without any layout changes:

    step(xs: tuple[nx arrays], vs: tuple[nu arrays]) -> tuple[nx arrays]

dt and model parameters are baked in as Python floats by each factory (they
are static per controller). Every factory here is the Euler discretization of
the matching continuous model in models/dynamics.py, so
``euler_step(f, x, u, dt)`` on the scan path and the tile step in the kernel
are the same function — parity is tested in tests/test_generic_tick.py.

A custom model needs its own tile step, typically under ten lines: the
kernel holds one vector per state dimension, and stacking them into an
``(..., nx)`` array is not an operation its compiler supports.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax.numpy as jnp

from .dynamics import DynamicBicycleParams, FourWheelParams

Tiles = Tuple[jnp.ndarray, ...]
TileStep = Callable[[Sequence[jnp.ndarray], Sequence[jnp.ndarray]], Tiles]


def unicycle_tile(dt: float) -> TileStep:
    """Euler diff-drive: state (x, y, yaw); control (v, ω).

    Matches euler_step(unicycle, ·, ·, dt) — the update of
    controllers/mppi_differential_drive.py:182-198.
    """
    dt = float(dt)

    def step(xs, vs):
        x, y, yaw = xs
        v, w = vs
        return (
            x + v * jnp.cos(yaw) * dt,
            y + v * jnp.sin(yaw) * dt,
            yaw + w * dt,
        )

    return step


def kinematic_bicycle_tile(dt: float, wheel_base: float = 2.5) -> TileStep:
    """Euler kinematic bicycle: state (x, y, yaw, v); control (δ, a).

    Matches euler_step(kinematic_bicycle, ·, ·, dt) — the update of
    controllers/mppi_race_car_obstacle.py:200-214.
    """
    dt, inv_L = float(dt), 1.0 / float(wheel_base)

    def step(xs, vs):
        x, y, yaw, v = xs
        steer, accel = vs
        return (
            x + v * jnp.cos(yaw) * dt,
            y + v * jnp.sin(yaw) * dt,
            yaw + v * jnp.tan(steer) * inv_L * dt,
            v + accel * dt,
        )

    return step


def four_wheel_torque_tile(dt: float, params: Optional[FourWheelParams] = None) -> TileStep:
    """Euler four-wheel torque model: state (x, y, θ, v, ω); control
    (τ_fr, τ_fl, τ_rr, τ_rl).

    Matches euler_step(four_wheel_torque, ·, ·, dt) — the continuous model of
    controllers/mpc_differential_dynamics.py:98-105.
    """
    if params is None:
        params = FourWheelParams.default()
    dt = float(dt)
    r, m = float(params.wheel_radius), float(params.mass)
    L, inertia = float(params.wheel_sep), float(params.inertia)
    cv = r / (4.0 * m)
    cw = r / (L * inertia) * 0.5

    def step(xs, vs):
        x, y, theta, v, omega = xs
        t_fr, t_fl, t_rr, t_rl = vs
        return (
            x + v * jnp.cos(theta) * dt,
            y + v * jnp.sin(theta) * dt,
            theta + omega * dt,
            v + cv * (t_fr + t_fl + t_rr + t_rl) * dt,
            omega + cw * ((t_fr + t_rr) - (t_fl + t_rl)) * dt,
        )

    return step


def dynamic_bicycle_tile(
    dt: float, params: Optional[DynamicBicycleParams] = None
) -> TileStep:
    """Euler dynamic bicycle with tire slip: state (x, y, yaw, v);
    control (a, δ).

    Matches euler_step(dynamic_bicycle, ·, ·, dt) — the single-track model of
    controllers/mpc_racecar_class.py:34-44, including the vx≈0 epsilon guard.
    """
    if params is None:
        params = DynamicBicycleParams.default()
    dt = float(dt)
    lf, lr = float(params.lf), float(params.lr)
    cf, cr = float(params.cornering_front), float(params.cornering_rear)
    inv_m = 1.0 / float(params.mass)
    beta_gain = lr / (lf + lr)

    def step(xs, vs):
        x, y, yaw, v = xs
        a, steer = vs
        beta = jnp.arctan(beta_gain * jnp.tan(steer))
        vx = v * jnp.cos(beta)
        vx_safe = jnp.where(jnp.abs(vx) < 1e-6, jnp.float32(1e-6), vx)
        fy = 2.0 * (
            cf * jnp.sin(jnp.arctan((v * jnp.sin(beta) + lf * yaw) / vx_safe))
            * jnp.cos(steer)
            + cr * jnp.sin(jnp.arctan((v * jnp.sin(beta) - lr * yaw) / vx_safe))
        )
        return (
            x + v * jnp.cos(yaw + beta) * dt,
            y + v * jnp.sin(yaw + beta) * dt,
            yaw + v * jnp.sin(beta) / lr * dt,
            v + (a - fy * jnp.sin(steer)) * inv_m * dt,
        )

    return step


__all__ = [
    "TileStep",
    "unicycle_tile",
    "kinematic_bicycle_tile",
    "four_wheel_torque_tile",
    "dynamic_bicycle_tile",
]
