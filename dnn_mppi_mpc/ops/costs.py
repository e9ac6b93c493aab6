"""Cost and collision primitives, batched over arbitrary leading dims.

Re-designs the reference's scalar per-state cost functions as array ops:

* quadratic waypoint tracking       — controllers/mppi_differential_drive.py:222-249
* race-car tracking w/ yaw wrap     — controllers/mppi_race_car_obstacle.py:147-171
* circle-robot collision penalty    — controllers/mppi_differential_drive_obs.py:301-313
* vehicle-polygon vs circles        — controllers/mppi_race_car_obstacle.py:241-274
* exponential soft obstacle cost    — test/test_mppi_diff_obs.py:44-66
* control-energy term γ·uᵀΣ⁻¹v      — controllers/mppi_differential_drive.py:124

Collision indicators use a large-but-float32-safe penalty (the reference adds
1.0e10 in float32 — overflow-adjacent when summed over T; see SURVEY §7).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

# Large enough to dominate any tracking cost after softmax, small enough that
# T * penalty stays far from float32 max (reference uses 1.0e10).
COLLISION_PENALTY = 1.0e7


COLLISION_MODES = ("none", "circle", "polygon", "soft")


@dataclasses.dataclass(frozen=True)
class TrackingSpec:
    """Static constants of the waypoint-tracking cost (solvers.mppi.
    make_tracking_costs). The scan path closes over them; the rollout kernel
    compiles them in — one record keeps the two on the same cost."""

    wrap_yaw: bool = False
    collision: str = "none"
    robot_radius: float = 0.5
    vehicle_length: float = 4.0
    vehicle_width: float = 3.0
    safety_margin_rate: float = 1.5
    soft_safety_distance: float = 2.0
    soft_weight: float = 100.0

    def __post_init__(self):
        if self.collision not in COLLISION_MODES:
            raise ValueError(f"unknown collision mode: {self.collision!r}")


def quadratic_tracking_cost(
    x: jnp.ndarray, ref: jnp.ndarray, weight: jnp.ndarray, wrap_yaw: bool = False
) -> jnp.ndarray:
    """Σ_i w_i (x_i − ref_i)² over the last axis.

    With ``wrap_yaw`` the third state is wrapped to [0, 2π) before differencing,
    matching controllers/mppi_race_car_obstacle.py:151.
    """
    if wrap_yaw:
        yaw = jnp.mod(x[..., 2] + 2.0 * jnp.pi, 2.0 * jnp.pi)
        x = x.at[..., 2].set(yaw) if hasattr(x, "at") else x
    err = x - ref
    return jnp.sum(weight * err * err, axis=-1)


def control_energy_cost(
    u_nominal: jnp.ndarray, v: jnp.ndarray, sigma_inv: jnp.ndarray, gamma: float
) -> jnp.ndarray:
    """Information-theoretic control cost γ·uᵀΣ⁻¹v
    (controllers/mppi_differential_drive.py:124)."""
    return gamma * jnp.einsum("...i,ij,...j->...", u_nominal, sigma_inv, v)


def circle_robot_collision(
    xy: jnp.ndarray, obstacles: jnp.ndarray, robot_radius: float = 0.5
) -> jnp.ndarray:
    """1.0 where a circular robot overlaps any circular obstacle, else 0.0.

    ``obstacles`` is (n_obs, 3) = (ox, oy, r). Mirrors the circle test of
    controllers/mppi_differential_drive_obs.py:301-313; pass the EFFECTIVE
    radius — the reference inflates the 0.5 m robot by its safety margin
    (×1.5 → 0.75), which the cost/kernel binders apply before calling here
    (round-4 strict crosscheck finding).
    """
    d2 = jnp.sum((xy[..., None, :2] - obstacles[..., :, :2]) ** 2, axis=-1)
    hit = d2 < (obstacles[..., :, 2] + robot_radius) ** 2
    return jnp.any(hit, axis=-1).astype(xy.dtype)


# 9-point vehicle outline in body frame, unit half-extents; scaled by (l/2, w/2).
# Point order follows controllers/mppi_race_car_obstacle.py:263-264. The plain
# tuples are THE canonical definition — the rollout kernel imports them
# (unrolled per-point code), the XLA path uses the array forms below; one
# source keeps the scan path and the kernel pinned to the same polygon.
VEHICLE_OUTLINE_X = (-1.0, -1.0, 0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0)
VEHICLE_OUTLINE_Y = (0.0, 1.0, 1.0, 1.0, 0.0, -1.0, -1.0, -1.0, 0.0)
# numpy (not jnp): a module-level jnp.array initializes the XLA backend as an
# import side effect, which breaks jax.distributed.initialize for every
# downstream user ("must be called before any JAX calls"); numpy constants
# convert for free at trace time.
_OUTLINE_X = np.asarray(VEHICLE_OUTLINE_X, np.float32)
_OUTLINE_Y = np.asarray(VEHICLE_OUTLINE_Y, np.float32)


def vehicle_polygon_collision(
    pose: jnp.ndarray,
    obstacles: jnp.ndarray,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    safety_margin_rate: float = 1.5,
) -> jnp.ndarray:
    """1.0 where any of 9 vehicle-outline points lies inside an obstacle circle.

    ``pose`` is (..., >=3) with (x, y, yaw) leading. Vectorized form of
    controllers/mppi_race_car_obstacle.py:241-274: outline scaled by the safety
    margin, rotated by yaw, translated to (x, y), tested against all circles.
    """
    x, y, yaw = pose[..., 0], pose[..., 1], pose[..., 2]
    hl = 0.5 * vehicle_length * safety_margin_rate
    hw = 0.5 * vehicle_width * safety_margin_rate
    bx = _OUTLINE_X * hl  # (9,)
    by = _OUTLINE_Y * hw
    c, s = jnp.cos(yaw)[..., None], jnp.sin(yaw)[..., None]
    px = bx * c - by * s + x[..., None]  # (..., 9)
    py = bx * s + by * c + y[..., None]
    dx = px[..., :, None] - obstacles[..., None, :, 0]  # (..., 9, n_obs)
    dy = py[..., :, None] - obstacles[..., None, :, 1]
    hit = dx * dx + dy * dy < obstacles[..., None, :, 2] ** 2
    return jnp.any(hit, axis=(-1, -2)).astype(pose.dtype)


def soft_obstacle_cost(
    xy: jnp.ndarray,
    obstacle_xy: jnp.ndarray,
    safety_distance: float = 2.0,
    weight: float = 100.0,
) -> jnp.ndarray:
    """Exponential soft obstacle penalty — test/test_mppi_diff_obs.py:59-64:
    Σ_obs exp(d_safe − d)·[d < d_safe], scaled by ``weight``."""
    d = jnp.sqrt(
        jnp.sum((xy[..., None, :2] - obstacle_xy[..., :, :2]) ** 2, axis=-1) + 1e-12
    )
    per_obs = jnp.exp(safety_distance - d) * (d < safety_distance)
    return weight * jnp.sum(per_obs, axis=-1)


def einsum_quadratic_cost(
    x: jnp.ndarray, ref: jnp.ndarray, Q_diag: jnp.ndarray
) -> jnp.ndarray:
    """Batched (x−ref)ᵀQ(x−ref) with diagonal Q — the einsum stage cost of
    test/test_mppi_diff_obs.py:50-51."""
    err = x - ref
    return jnp.sum(err * Q_diag * err, axis=-1)


__all__ = [
    "COLLISION_PENALTY",
    "COLLISION_MODES",
    "TrackingSpec",
    "quadratic_tracking_cost",
    "control_energy_cost",
    "circle_robot_collision",
    "vehicle_polygon_collision",
    "soft_obstacle_cost",
    "einsum_quadratic_cost",
]
