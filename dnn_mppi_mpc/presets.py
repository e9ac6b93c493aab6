"""One-call constructors for every reference controller configuration.

A user of SokhengDin/DNN-MPPI-MPC should find each controller here with its
reference defaults pre-wired (hyperparameters cited to the reference mains),
returning a ready solver plus its runtime params.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp

from .config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    SQPConfig,
    Temperature,
)
from .models.dynamics import (
    BicycleParams,
    DynamicBicycleParams,
    dynamic_bicycle,
    four_wheel_torque,
    kinematic_bicycle,
    residual_dynamics,
    unicycle,
)
from .models.integrators import euler_step
from .models.tile import kinematic_bicycle_tile, unicycle_tile
from .solvers.mppi import MPPISolver, make_tracking_costs
from .solvers.sqp import NMPCSolver, OCPParams, circle_obstacle_h


def diff_drive_mppi(
    ref_path: jnp.ndarray,
    num_samples: int = 100,
    horizon: int = 10,
    dt: float = 0.1,
    obstacles: Optional[jnp.ndarray] = None,
    use_pallas: Optional[bool] = None,
    **overrides,
) -> Tuple[MPPISolver, MPPIParams]:
    """Diff-drive waypoint-tracking MPPI.

    Defaults from controllers/mppi_differential_drive.py:399-410 (δt=0.1,
    K=100, T=10, exploration=1e-4, λ=1, α=0.2, Σ=diag(.1,.01), weights
    (5,5,10), v∈±5, ω∈±3.14); with ``obstacles`` the circle-collision variant
    of mppi_differential_drive_obs.py (K=500, T=20 in its main :428-486).
    ``use_pallas`` overrides MPPISolver's platform choice of the rollout
    kernel.
    """
    # defaults-then-update so **overrides can replace ANY config field
    # (passing e.g. filter_window used to raise 'multiple values for keyword
    # argument' — round-2 review finding; same pattern in all MPPI presets)
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=0.2,
        exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=min(10, horizon),
        waypoint_search_len=20,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    params = MPPIParams(
        sigma=jnp.array([[0.1, 0.0], [0.0, 0.01]]),
        stage_weight=jnp.array([5.0, 5.0, 10.0]),
        terminal_weight=jnp.array([5.0, 5.0, 10.0]),
        u_min=jnp.array([-5.0, -3.14]),
        u_max=jnp.array([5.0, 3.14]),
        ref_path=jnp.asarray(ref_path),
        obstacles=obstacles,
    )
    step = lambda x, u: euler_step(unicycle, x, u, dt)
    stage, terminal = make_tracking_costs(
        cfg, collision="none" if obstacles is None else "circle"
    )
    solver = MPPISolver(
        cfg, step, stage, terminal, use_pallas=use_pallas,
        tile_dynamics=unicycle_tile(dt),
    )
    return solver, params


def racecar_mppi(
    ref_path: jnp.ndarray,
    num_samples: int = 100,
    horizon: int = 10,
    dt: float = 0.05,
    wheel_base: float = 2.5,
    obstacles: Optional[jnp.ndarray] = None,
    use_pallas: Optional[bool] = None,
    **overrides,
) -> Tuple[MPPISolver, MPPIParams]:
    """Race-car MPPI (kinematic bicycle) with optional polygon collision.

    Defaults from controllers/mppi_race_car_obstacle.py:11-62 (δt=.05, L=2.5,
    λ=50, α=1, exploration=.01, Σ=diag(.5,.1), 4-term weights (50,50,1,20),
    steer ±0.523, accel ±2.0, vehicle 4×3 m with 1.5× safety margin).
    ``use_pallas`` overrides MPPISolver's platform choice of the rollout
    kernel.
    """
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=4,
        dim_u=2,
        dt=dt,
        lam=50.0,
        alpha=1.0,
        exploration=0.01,
        temperature=Temperature.LAMBDA,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_PADDED,
        filter_window=min(10, horizon),
        waypoint_search_len=200,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    params = MPPIParams(
        sigma=jnp.array([[0.5, 0.0], [0.0, 0.1]]),
        stage_weight=jnp.array([50.0, 50.0, 1.0, 20.0]),
        terminal_weight=jnp.array([50.0, 50.0, 1.0, 20.0]),
        u_min=jnp.array([-0.523, -2.0]),
        u_max=jnp.array([0.523, 2.0]),
        ref_path=jnp.asarray(ref_path),
        obstacles=obstacles,
    )
    bp = BicycleParams(wheel_base=jnp.asarray(wheel_base))
    step = lambda x, u: euler_step(lambda s, a: kinematic_bicycle(s, a, bp), x, u, dt)
    stage, terminal = make_tracking_costs(
        cfg,
        wrap_yaw=True,
        collision="none" if obstacles is None else "polygon",
        vehicle_length=4.0,
        vehicle_width=3.0,
        safety_margin_rate=1.5,
    )
    solver = MPPISolver(
        cfg, step, stage, terminal, use_pallas=use_pallas,
        tile_dynamics=kinematic_bicycle_tile(dt, wheel_base),
    )
    return solver, params


def goal_seeking_mppi(
    goal: jnp.ndarray,
    num_samples: int = 1500,
    horizon: int = 50,
    dt: float = 0.05,
    obstacles: Optional[jnp.ndarray] = None,
    obstacle_velocities: Optional[jnp.ndarray] = None,
    use_pallas: Optional[bool] = None,
    **overrides,
) -> Tuple[MPPISolver, MPPIParams]:
    """pytorch_mppi-style goal-point MPPI with soft obstacle costs.

    The configuration of test/test_mppi_diff_obs.py:631-667 (K=1500, T=50,
    δt=.05, einsum Q=diag(30,5,9), soft exponential obstacle penalty, moving
    obstacles, Savitzky-Golay smoothing). The 'path' is the single goal pose.
    ``use_pallas`` overrides MPPISolver's platform choice of the rollout
    kernel.
    """
    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=1.0,
        exploration=0.0,
        temperature=Temperature.LAMBDA,
        filter=SmoothingFilter.SAVGOL,
        filter_window=min(51, horizon),
        savgol_polyorder=3,
        waypoint_search_len=1,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    params = MPPIParams(
        sigma=jnp.array([[0.5, 0.0], [0.0, 0.3]]),  # bullet_mppi_… :316-337
        stage_weight=jnp.array([30.0, 5.0, 9.0]),  # test_mppi_diff_obs.py:47
        terminal_weight=jnp.array([30.0, 5.0, 9.0]),
        # the spec's control_cost = aᵀ·diag(0.1, 0.1)·a on the clamped
        # action (test_mppi_diff_obs.py:48-53) — added in round 4; the
        # engine's γ·uᵀΣ⁻¹v energy term does not cover it
        control_weight=jnp.array([0.1, 0.1]),
        u_min=jnp.array([-2.0, -2.0]),
        u_max=jnp.array([2.0, 2.0]),
        ref_path=jnp.asarray(goal)[None, :],
        obstacles=obstacles,
        obstacle_velocities=obstacle_velocities,
    )
    step = lambda x, u: euler_step(unicycle, x, u, dt)
    stage, terminal = make_tracking_costs(
        cfg, collision="none" if obstacles is None else "soft",
        soft_safety_distance=2.0, soft_weight=100.0,
    )
    solver = MPPISolver(
        cfg, step, stage, terminal, use_pallas=use_pallas,
        tile_dynamics=unicycle_tile(dt),
    )
    return solver, params


def _ls_params(Q, R, Qe, goal, N, lbx, ubx, lbu, ubu, p=None) -> OCPParams:
    nu = R.shape[0]
    return OCPParams(
        Q=Q,
        R=R,
        Qe=Qe,
        yref=jnp.concatenate([goal, jnp.zeros(nu)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=lbx,
        ubx=ubx,
        lbu=lbu,
        ubu=ubu,
        p=p,
    )


def diff_drive_nmpc(
    goal: jnp.ndarray,
    N: int = 30,
    dt: float = 0.1,
    obstacles: Optional[jnp.ndarray] = None,
    sqp_iters: int = 2,
    **overrides,
) -> Tuple[NMPCSolver, OCPParams]:
    """Diff-drive NMPC with circular obstacle h-constraints.

    The MPCController recipe of mpc_differential_drive_obstacle_static.py
    (LINEAR_LS, ERK(4,3), SQP-RTI, box bounds, (x−ox)²+(y−oy)² ≥ r² rows).
    ``obstacles`` is (n, 3) = (ox, oy, radius+safe_distance).
    """
    cfg = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=sqp_iters,
        qp_iters=overrides.pop("qp_iters", 12),
        n_h_constraints=0 if obstacles is None else obstacles.shape[0],
        **overrides,
    )
    solver = NMPCSolver(cfg, unicycle, h_fn=None if obstacles is None else circle_obstacle_h)
    params = _ls_params(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        R=jnp.diag(jnp.array([0.5, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        goal=jnp.asarray(goal),
        N=N,
        lbx=jnp.full(3, -10.0),
        ubx=jnp.full(3, 10.0),
        lbu=jnp.array([-1.0, -1.0]),
        ubu=jnp.array([1.0, 1.0]),
        p=obstacles,
    )
    return solver, params


def racecar_nmpc(
    goal: jnp.ndarray,
    N: int = 50,
    dt: float = 0.05,
    wheel_base: float = 0.325,
    dynamic_model: bool = False,
    sqp_iters: int = 2,
    **overrides,
) -> Tuple[NMPCSolver, OCPParams]:
    """Race-car NMPC: kinematic bicycle (mpc_racecar.py, L=0.325, N=50) or the
    dynamic single-track model with tire slip (mpc_racecar_class.py)."""
    cfg = SQPConfig(N=N, dim_x=4, dim_u=2, dt=dt, sqp_iters=sqp_iters,
                    qp_iters=overrides.pop("qp_iters", 12), **overrides)
    if dynamic_model:
        dbp = DynamicBicycleParams.default()
        dyn = lambda x, u: dynamic_bicycle(x, u, dbp)
        # dynamic_bicycle's control layout is (a, δ) — accel FIRST
        # (mpc_racecar_class.py:34-44, models/dynamics.py:192); applying the
        # kinematic model's (δ, a) bounds here silently constrained accel to
        # ±0.4 and allowed ±2 rad of steering (round-2 review finding).
        lbu, ubu = jnp.array([-2.0, -0.4]), jnp.array([2.0, 0.4])
    else:
        bp = BicycleParams(wheel_base=jnp.asarray(wheel_base))
        dyn = lambda x, u: kinematic_bicycle(x, u, bp)
        lbu, ubu = jnp.array([-0.4, -2.0]), jnp.array([0.4, 2.0])
    solver = NMPCSolver(cfg, dyn)
    params = _ls_params(
        Q=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        R=jnp.diag(jnp.array([0.5, 0.5])),
        Qe=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        goal=jnp.asarray(goal),
        N=N,
        lbx=jnp.array([-10.0, -10.0, -10.0, -3.0]),
        ubx=jnp.array([10.0, 10.0, 10.0, 3.0]),
        lbu=lbu,
        ubu=ubu,
    )
    return solver, params


def four_wheel_nmpc(
    goal: jnp.ndarray, N: int = 20, dt: float = 0.1, sqp_iters: int = 2, **overrides
) -> Tuple[NMPCSolver, OCPParams]:
    """Four-wheel torque-input NMPC (mpc_differential_dynamics.py:71-131).

    Defaults to the implicit Gauss-Legendre integrator exactly as the
    reference deploys this model (integrator_type='IRK',
    mpc_differential_dynamics.py:198); pass ``integrator='erk'`` for the
    explicit engine. Per-tick IRK parity vs the f64 acados-semantics oracle
    is gated in tests/test_oracle_nmpc.py.
    """
    cfg = SQPConfig(N=N, dim_x=5, dim_u=4, dt=dt, sqp_iters=sqp_iters,
                    integrator=overrides.pop("integrator", "irk"),
                    qp_iters=overrides.pop("qp_iters", 12), **overrides)
    solver = NMPCSolver(cfg, four_wheel_torque)
    params = _ls_params(
        Q=jnp.diag(jnp.array([20.0, 20.0, 1.0, 1.0, 1.0])),
        R=jnp.eye(4) * 0.1,
        Qe=jnp.diag(jnp.array([20.0, 20.0, 1.0, 1.0, 1.0])),
        goal=jnp.asarray(goal),
        N=N,
        lbx=jnp.full(5, -20.0),
        ubx=jnp.full(5, 20.0),
        lbu=jnp.full(4, -5.0),
        ubu=jnp.full(4, 5.0),
    )
    return solver, params


def dnn_mppi(
    ref_path: jnp.ndarray,
    learned_fn: Callable[[jnp.ndarray], jnp.ndarray],
    num_samples: int = 1024,
    horizon: int = 25,
    dt: float = 0.05,
    residual_level: str = "step",
    **overrides,
) -> Tuple[MPPISolver, MPPIParams]:
    """DNN-MPPI: sampling MPPI over unicycle + learned residual — BASELINE
    config 5's MPPI half. ``learned_fn`` maps concat(x, u) features to a
    residual (models.learned.residual_from_train_state binds MLP *or*
    conv-ResNet18/50 train states — the reference's resnet regressors,
    dnn/resnet18.py:68-69, dnn/resnet50.py:104-105, as controller dynamics).

    ``residual_level``:
      * 'step' — residual corrects the DISCRETE transition,
        x⁺ = euler(x,u) + NN(x,u): the quantity the data-collection pipeline
        actually regresses (errors = plant_step − nominal_step,
        envs/closed_loop.collect_residual_dataset; reference producer
        train/bullet_mpc_differential_drive.py:96).
      * 'rate' — residual corrects ẋ like the reference's NMPC models
        (f_expl = unicycle + residual,
        simulation/bullet_differential_drive_dnn.py:88-92), then Euler.

    The K-batched net evaluation is (K, feat) matmuls/convs that XLA hands
    to its matrix-product libraries inside the scan — the rollout kernel
    does not take learned dynamics.
    """
    def _learned(feats):
        # pin the residual to the rollout dtype: under x64 test mode a net
        # (or stand-in) returning float64 would promote the scan carry
        return learned_fn(feats).astype(feats.dtype)

    if residual_level == "rate":
        dyn = residual_dynamics(unicycle, _learned)
        step = lambda x, u: euler_step(dyn, x, u, dt)
    elif residual_level == "step":
        def step(x, u):
            feats = jnp.concatenate([x, u], axis=-1)
            return euler_step(unicycle, x, u, dt) + _learned(feats)
    else:
        raise ValueError(f"residual_level must be 'step' or 'rate': {residual_level!r}")

    kw = dict(
        num_samples=num_samples,
        horizon=horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=0.2,
        exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=min(10, horizon),
        waypoint_search_len=20,
    )
    kw.update(overrides)
    cfg = MPPIConfig(**kw)
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.0], [0.0, 0.1]]),
        stage_weight=jnp.array([8.0, 8.0, 2.0]),
        terminal_weight=jnp.array([8.0, 8.0, 2.0]),
        u_min=jnp.array([-3.0, -3.14]),
        u_max=jnp.array([3.0, 3.14]),
        ref_path=jnp.asarray(ref_path),
    )
    stage, terminal = make_tracking_costs(cfg)
    return MPPISolver(cfg, step, stage, terminal), params


def dnn_nmpc(
    goal: jnp.ndarray,
    learned_fn: Callable[[jnp.ndarray], jnp.ndarray],
    N: int = 10,
    dt: float = 0.1,
    obstacles: Optional[jnp.ndarray] = None,
    sqp_iters: int = 2,
    **overrides,
) -> Tuple[NMPCSolver, OCPParams]:
    """DNN-NMPC: unicycle + learned residual through the SQP engine — the
    whole l4casadi path of simulation/bullet_differential_drive_dnn.py in one
    call. ``learned_fn`` maps concat(x, u) features to a rate residual (see
    models.learned.make_residual_fn)."""
    solver_dyn = residual_dynamics(unicycle, learned_fn)
    cfg = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=sqp_iters,
        qp_iters=overrides.pop("qp_iters", 12),
        n_h_constraints=0 if obstacles is None else obstacles.shape[0],
        **overrides,
    )
    solver = NMPCSolver(
        cfg, solver_dyn, h_fn=None if obstacles is None else circle_obstacle_h
    )
    params = _ls_params(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.5])),
        R=jnp.diag(jnp.array([0.2, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.5])),
        goal=jnp.asarray(goal),
        N=N,
        lbx=jnp.full(3, -20.0),
        ubx=jnp.full(3, 20.0),
        lbu=jnp.array([-2.0, -2.0]),
        ubu=jnp.array([2.0, 2.0]),
        p=obstacles,
    )
    return solver, params


__all__ = [
    "diff_drive_mppi",
    "racecar_mppi",
    "goal_seeking_mppi",
    "diff_drive_nmpc",
    "racecar_nmpc",
    "four_wheel_nmpc",
    "dnn_mppi",
    "dnn_nmpc",
]
