"""Parity tests for the GPU rollout kernel (ops/pallas/rollout.py).

The kernel runs in the Pallas interpreter here and must reproduce the scan
engine (solvers/mppi.py) on injected ε for every model family — unicycle,
four-wheel torque (nx=5, nu=4), kinematic bicycle with wrap-yaw tracking,
dynamic bicycle with tire slip — and every collision mode.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.config import (
    CostAccumulation,
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    Temperature,
)
from dnn_mppi_mpc.models import (
    dynamic_bicycle,
    dynamic_bicycle_tile,
    euler_step,
    four_wheel_torque,
    four_wheel_torque_tile,
    kinematic_bicycle,
    kinematic_bicycle_tile,
    unicycle,
    unicycle_tile,
)
from dnn_mppi_mpc.models.dynamics import BicycleParams
from dnn_mppi_mpc.solvers.mppi import (
    MPPIState,
    make_rollout_kernel,
    make_tracking_costs,
    mppi_step,
)

K, T, DT = 256, 10, 0.05


def _cfg(nx, nu, **kw):
    base = dict(
        num_samples=K,
        horizon=T,
        dim_x=nx,
        dim_u=nu,
        dt=DT,
        lam=0.8,
        alpha=0.3,
        exploration=0.25,
        temperature=Temperature.LAMBDA,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=5,
        waypoint_search_len=8,
    )
    base.update(kw)
    return MPPIConfig(**base)


def _path(ncols, n=40):
    rng = np.random.default_rng(7)
    cols = [np.linspace(0.0, 4.0, n), np.sin(np.linspace(0.0, 2.0, n))]
    for _ in range(ncols - 2):
        cols.append(rng.normal(0.0, 0.4, n).cumsum() * 0.1)
    return jnp.asarray(np.stack(cols, axis=1), jnp.float32)


def _sigma(nu, seed=5):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.2, (nu, nu))
    return jnp.asarray(A @ A.T + 0.05 * np.eye(nu), jnp.float32)


def _noise(cfg, params, seed=3):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.multivariate_normal(
            np.zeros(cfg.dim_u), np.asarray(params.sigma), (K, T)
        ),
        jnp.float32,
    )


def _state(cfg, seed=0):
    st = MPPIState.init(cfg)
    return dataclasses.replace(
        st,
        u_prev=jnp.asarray(
            np.random.default_rng(seed).normal(0, 0.3, (T, cfg.dim_u)),
            jnp.float32,
        ),
    )


def _kernel(cfg, tile, stage):
    """The rollout kernel for these costs, in the Pallas interpreter."""
    return make_rollout_kernel(cfg, tile, stage.tracking_spec, interpret=True)


def _run_both(cfg, params, step_fn, stage, terminal, tick, x0, seed=3):
    eps = _noise(cfg, params, seed=seed)
    state = _state(cfg)
    u0_t, st_t, aux_t = jax.jit(
        lambda p, s, x, n: mppi_step(
            cfg, step_fn, stage, terminal, p, s, x, n, rollout_fn=tick
        )
    )(params, state, x0, eps)
    u0_r, st_r, aux_r = jax.jit(
        lambda p, s, x, n: mppi_step(cfg, step_fn, stage, terminal, p, s, x, n)
    )(params, state, x0, eps)
    np.testing.assert_allclose(
        np.asarray(aux_t.costs), np.asarray(aux_r.costs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(
        np.asarray(aux_t.weights), np.asarray(aux_r.weights), rtol=3e-4, atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(u0_t), np.asarray(u0_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st_t.u_prev), np.asarray(st_r.u_prev), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("obstacles", [False, True])
@pytest.mark.parametrize("last", [False, True])
def test_generic_matches_scan_unicycle(obstacles, last):
    """The generic kernel with the unicycle tile reproduces the scan engine
    (same contract the specialized diff-drive tick satisfies)."""
    cfg = _cfg(3, 2, accumulation=CostAccumulation.LAST if last else CostAccumulation.SUM)
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.05], [0.05, 0.1]], jnp.float32),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.array([-1.5, -2.0], jnp.float32),
        u_max=jnp.array([1.5, 2.0], jnp.float32),
        ref_path=_path(3),
        obstacles=(
            jnp.array([[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]], jnp.float32)
            if obstacles
            else None
        ),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(
        cfg, collision="circle" if obstacles else "none", robot_radius=0.5
    )
    tick = _kernel(cfg, unicycle_tile(DT), stage)
    _run_both(cfg, params, step_fn, stage, terminal, tick,
              jnp.array([0.1, -0.05, 0.2], jnp.float32))


def test_generic_matches_scan_four_wheel():
    """Four-wheel torque model (nx=5, nu=4): a family no specialized kernel
    covers, on the fused path."""
    cfg = _cfg(5, 4)
    params = MPPIParams(
        sigma=_sigma(4),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.full((4,), -2.0, jnp.float32),
        u_max=jnp.full((4,), 2.0, jnp.float32),
        ref_path=_path(3),
    )
    step_fn = lambda x, u: euler_step(four_wheel_torque, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, four_wheel_torque_tile(DT), stage)
    x0 = jnp.array([0.1, -0.05, 0.2, 0.3, 0.05], jnp.float32)
    _run_both(cfg, params, step_fn, stage, terminal, tick, x0)


def test_generic_matches_scan_bicycle_wrap_yaw():
    """Kinematic bicycle with the race car's wrap-yaw tracking rule."""
    cfg = _cfg(4, 2)
    params = MPPIParams(
        sigma=jnp.array([[0.05, 0.0], [0.0, 0.3]], jnp.float32),
        stage_weight=jnp.array([6.0, 6.0, 2.0, 1.0], jnp.float32),
        terminal_weight=jnp.array([10.0, 10.0, 3.0, 1.0], jnp.float32),
        u_min=jnp.array([-0.5, -3.0], jnp.float32),
        u_max=jnp.array([0.5, 3.0], jnp.float32),
        ref_path=_path(4),
    )
    bp = BicycleParams(wheel_base=jnp.asarray(2.5))
    step_fn = lambda x, u: euler_step(
        lambda x_, u_: kinematic_bicycle(x_, u_, bp), x, u, DT
    )
    stage, terminal = make_tracking_costs(cfg, wrap_yaw=True)
    tick = _kernel(cfg, kinematic_bicycle_tile(DT, 2.5), stage)
    x0 = jnp.array([0.1, -0.05, -0.4, 1.0], jnp.float32)
    _run_both(cfg, params, step_fn, stage, terminal, tick, x0)


def test_generic_matches_scan_dynamic_bicycle_soft_moving():
    """Dynamic bicycle (tire slip) + soft exponential obstacles drifting
    in-rollout — the pytorch_mppi goal-seeking combination on a model family
    with no specialized kernel."""
    cfg = _cfg(4, 2)
    params = MPPIParams(
        sigma=jnp.array([[0.4, 0.0], [0.0, 0.05]], jnp.float32),
        stage_weight=jnp.array([4.0, 4.0], jnp.float32),
        terminal_weight=jnp.array([8.0, 8.0], jnp.float32),
        u_min=jnp.array([-2.0, -0.4], jnp.float32),
        u_max=jnp.array([2.0, 0.4], jnp.float32),
        ref_path=_path(2),
        obstacles=jnp.array([[1.5, 0.2, 0.3]], jnp.float32),
        obstacle_velocities=jnp.array([[0.4, -0.2]], jnp.float32),
    )
    step_fn = lambda x, u: euler_step(dynamic_bicycle, x, u, DT)
    stage, terminal = make_tracking_costs(
        cfg, collision="soft", soft_safety_distance=1.5, soft_weight=60.0
    )
    tick = _kernel(cfg, dynamic_bicycle_tile(DT), stage)
    x0 = jnp.array([0.0, 0.0, 0.1, 1.2], jnp.float32)
    _run_both(cfg, params, step_fn, stage, terminal, tick, x0)


def test_generic_matches_scan_polygon():
    """Kinematic bicycle + the race car's 9-point vehicle outline against
    circle obstacles, wrap-yaw tracking (the race-car configuration)."""
    cfg = _cfg(4, 2)
    params = MPPIParams(
        sigma=jnp.array([[0.05, 0.0], [0.0, 0.3]], jnp.float32),
        stage_weight=jnp.array([6.0, 6.0, 2.0, 1.0], jnp.float32),
        terminal_weight=jnp.array([10.0, 10.0, 3.0, 1.0], jnp.float32),
        u_min=jnp.array([-0.5, -3.0], jnp.float32),
        u_max=jnp.array([0.5, 3.0], jnp.float32),
        ref_path=_path(4),
        obstacles=jnp.array([[2.5, 2.0, 0.4], [1.2, -1.5, 0.5]], jnp.float32),
    )
    bp = BicycleParams(wheel_base=jnp.asarray(2.5))
    step_fn = lambda x, u: euler_step(
        lambda x_, u_: kinematic_bicycle(x_, u_, bp), x, u, DT
    )
    stage, terminal = make_tracking_costs(
        cfg, wrap_yaw=True, collision="polygon", vehicle_length=1.0,
        vehicle_width=0.6, safety_margin_rate=1.2,
    )
    tick = _kernel(cfg, kinematic_bicycle_tile(DT, 2.5), stage)
    x0 = jnp.array([0.1, -0.05, -0.4, 1.0], jnp.float32)
    _run_both(cfg, params, step_fn, stage, terminal, tick, x0)


def test_generic_matches_scan_large_window():
    """W > 32 takes the in-kernel loop window path (dynamic scalar loads)
    instead of the unrolled one — it must reproduce the scan engine too
    (round-2 review: this branch previously had no test at all)."""
    cfg = _cfg(3, 2, waypoint_search_len=48)
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.05], [0.05, 0.1]], jnp.float32),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.array([-1.5, -2.0], jnp.float32),
        u_max=jnp.array([1.5, 2.0], jnp.float32),
        ref_path=_path(3, n=80),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, unicycle_tile(DT), stage)
    _run_both(cfg, params, step_fn, stage, terminal, tick,
              jnp.array([0.1, -0.05, 0.2], jnp.float32))


def test_generic_guards():
    cfg = _cfg(3, 2, num_rollout_repeats=3)
    stage, _ = make_tracking_costs(cfg)
    with pytest.raises(ValueError, match="num_rollout_repeats"):
        make_rollout_kernel(cfg, unicycle_tile(DT), stage.tracking_spec)


def test_generic_rollout_matches_scan_four_wheel():
    """The kernel with circle obstacles on the four-wheel model matches the
    scan engine."""
    cfg = _cfg(5, 4)
    params = MPPIParams(
        sigma=_sigma(4),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.full((4,), -2.0, jnp.float32),
        u_max=jnp.full((4,), 2.0, jnp.float32),
        ref_path=_path(3),
        obstacles=jnp.array([[1.0, 0.4, 0.3]], jnp.float32),
    )
    step_fn = lambda x, u: euler_step(four_wheel_torque, x, u, DT)
    # margin pinned to 1.0 on BOTH sides: this test checks kernel-vs-scan
    # parity, and the default 1.5 margin happens to put one sample within
    # f32 rounding of the collision boundary for this RNG draw
    stage, terminal = make_tracking_costs(
        cfg, collision="circle", robot_radius=0.5, safety_margin_rate=1.0
    )
    rollout = _kernel(cfg, four_wheel_torque_tile(DT), stage)
    eps = _noise(cfg, params)
    state = _state(cfg)
    x0 = jnp.array([0.1, -0.05, 0.2, 0.3, 0.05], jnp.float32)
    u0_p, st_p, aux_p = jax.jit(
        lambda p, s, x, n: mppi_step(
            cfg, step_fn, stage, terminal, p, s, x, n, rollout_fn=rollout
        )
    )(params, state, x0, eps)
    u0_r, st_r, aux_r = jax.jit(
        lambda p, s, x, n: mppi_step(cfg, step_fn, stage, terminal, p, s, x, n)
    )(params, state, x0, eps)
    np.testing.assert_allclose(
        np.asarray(aux_p.costs), np.asarray(aux_r.costs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(np.asarray(u0_p), np.asarray(u0_r), rtol=1e-4, atol=1e-5)


def test_generic_rollout_sharded_matches_unsharded():
    """Sample-sharded kernel rollout under shard_map: the global sample-index
    offset must make sharded == unsharded (exploration split over global K)."""
    from dnn_mppi_mpc.parallel.sharding import make_mesh, make_sharded_mppi_step

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")

    cfg = _cfg(5, 4, num_samples=2048)
    params = MPPIParams(
        sigma=_sigma(4),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.full((4,), -2.0, jnp.float32),
        u_max=jnp.full((4,), 2.0, jnp.float32),
        ref_path=_path(3),
    )
    step_fn = lambda x, u: euler_step(four_wheel_torque, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    rollout = _kernel(cfg, four_wheel_torque_tile(DT), stage)

    mesh = make_mesh(("k",))
    sharded = make_sharded_mppi_step(
        cfg, step_fn, stage, terminal, mesh, rollout_fn=rollout
    )
    rng = np.random.default_rng(13)
    eps = jnp.asarray(
        rng.multivariate_normal(np.zeros(4), np.asarray(params.sigma), (2048, T)),
        jnp.float32,
    )
    x0 = jnp.array([0.1, -0.05, 0.2, 0.3, 0.05], jnp.float32)
    state = _state(cfg)

    u0_s, _, aux_s = sharded(params, state, x0, eps)
    u0_r, _, aux_r = jax.jit(
        lambda p, s, x, n: mppi_step(
            cfg, step_fn, stage, terminal, p, s, x, n, rollout_fn=rollout
        )
    )(params, state, x0, eps)
    np.testing.assert_allclose(np.asarray(u0_s), np.asarray(u0_r), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(aux_s.costs), np.asarray(aux_r.costs), rtol=1e-4, atol=1e-4
    )


def test_solver_guards():
    """use_pallas=True demands the kernel: without a tile form of the
    dynamics the solver refuses instead of silently running the scan."""
    from dnn_mppi_mpc.solvers.mppi import MPPISolver

    cfg = _cfg(3, 2)
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    with pytest.raises(ValueError, match="tile_dynamics"):
        MPPISolver(cfg, step_fn, stage, terminal, use_pallas=True)


def test_generic_guards_weight_mismatch():
    cfg = _cfg(3, 2)
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.05], [0.05, 0.1]], jnp.float32),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0], jnp.float32),  # mismatched
        u_min=jnp.array([-1.5, -2.0], jnp.float32),
        u_max=jnp.array([1.5, 2.0], jnp.float32),
        ref_path=_path(3),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, unicycle_tile(DT), stage)
    with pytest.raises(ValueError, match="n_track"):
        jax.jit(
            lambda p, s, x, n: mppi_step(
                cfg, step_fn, stage, terminal, p, s, x, n, rollout_fn=tick
            )
        )(params, _state(cfg), jnp.zeros(3, jnp.float32), _noise(cfg, params))


@pytest.mark.parametrize("seed", range(6))
def test_generic_fuzz_random_configs(seed):
    """Randomized (nx, nu, n_track, collision, accumulation, wrap-yaw) parity
    vs the scan engine under random *linear* dynamics — broad-spectrum
    evidence the generic kernel is shape- and config-agnostic."""
    rng = np.random.default_rng(100 + seed)
    nx = int(rng.choice([3, 4, 5]))
    nu = int(rng.choice([2, 3, 4]))
    n_track = int(rng.integers(2, nx + 1))
    Kf = int(rng.choice([128, 256]))
    Tf = int(rng.choice([5, 10]))
    dtf = float(rng.uniform(0.03, 0.12))
    wrap = bool(rng.choice([False, True])) and n_track >= 3
    collision = str(rng.choice(["none", "circle", "soft", "polygon"]))
    if collision == "polygon" and nx < 3:
        collision = "circle"
    last = bool(rng.choice([False, True]))
    moving = collision != "none" and bool(rng.choice([False, True]))

    # stable-ish random linear dynamics x' = x + (A x + B u) dt
    A = rng.normal(0.0, 0.3, (nx, nx)) - 0.5 * np.eye(nx)
    B = rng.normal(0.0, 0.5, (nx, nu))
    Aj, Bj = jnp.asarray(A, jnp.float32), jnp.asarray(B, jnp.float32)

    def step_fn(x, u):
        return x + (x @ Aj.T + u @ Bj.T) * dtf

    Al = [[float(A[i, k]) for k in range(nx)] for i in range(nx)]
    Bl = [[float(B[i, j]) for j in range(nu)] for i in range(nx)]

    def tile(xs, vs):
        out = []
        for i in range(nx):
            acc = xs[i]
            for k in range(nx):
                acc = acc + Al[i][k] * xs[k] * dtf
            for j in range(nu):
                acc = acc + Bl[i][j] * vs[j] * dtf
            out.append(acc)
        return tuple(out)

    M = rng.normal(0.0, 0.3, (nu, nu))
    sigma = jnp.asarray(M @ M.T + 0.05 * np.eye(nu), jnp.float32)
    n_obs = int(rng.integers(1, 3))
    cfg = MPPIConfig(
        num_samples=Kf,
        horizon=Tf,
        dim_x=nx,
        dim_u=nu,
        dt=dtf,
        lam=float(rng.uniform(0.5, 2.0)),
        alpha=float(rng.uniform(0.0, 0.9)),
        exploration=float(rng.choice([0.0001, 0.2])),
        temperature=Temperature.LAMBDA,
        accumulation=CostAccumulation.LAST if last else CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=5,
        waypoint_search_len=int(rng.choice([6, 12])),
    )
    params = MPPIParams(
        sigma=sigma,
        stage_weight=jnp.asarray(rng.uniform(0.5, 10.0, n_track), jnp.float32),
        terminal_weight=jnp.asarray(rng.uniform(0.5, 10.0, n_track), jnp.float32),
        u_min=jnp.asarray(-rng.uniform(1.0, 3.0, nu), jnp.float32),
        u_max=jnp.asarray(rng.uniform(1.0, 3.0, nu), jnp.float32),
        ref_path=_path(max(n_track, 2)),
        # obstacles kept >= 1.5 from the start region so collision-free
        # samples always exist: an all-colliding config saturates S at the
        # 1e7 penalty where f32 ULP is ~1 and the softmax argmin is decided
        # by rounding — not a meaningful parity comparison.
        obstacles=(
            jnp.asarray(
                np.concatenate(
                    [
                        rng.uniform(1.5, 4.0, (n_obs, 1)),
                        rng.uniform(-2.5, -1.5, (n_obs, 1)),
                        rng.uniform(0.2, 0.5, (n_obs, 1)),
                    ],
                    axis=1,
                ),
                jnp.float32,
            )
            if collision != "none"
            else None
        ),
        obstacle_velocities=(
            jnp.asarray(rng.normal(0.0, 0.4, (n_obs, 2)), jnp.float32)
            if moving
            else None
        ),
    )
    stage, terminal = make_tracking_costs(
        cfg,
        wrap_yaw=wrap,
        collision=collision,
        robot_radius=0.4,
        soft_safety_distance=1.2,
        soft_weight=40.0,
    )
    tick = _kernel(cfg, tile, stage)
    eps = jnp.asarray(
        rng.multivariate_normal(np.zeros(nu), np.asarray(sigma), (Kf, Tf)),
        jnp.float32,
    )
    state = MPPIState.init(cfg)
    state = dataclasses.replace(
        state, u_prev=jnp.asarray(rng.normal(0, 0.3, (Tf, nu)), jnp.float32)
    )
    x0 = jnp.asarray(rng.uniform(-0.4, 0.4, nx), jnp.float32)
    u0_t, _, aux_t = jax.jit(
        lambda p, s, x, n: mppi_step(
            cfg, step_fn, stage, terminal, p, s, x, n, rollout_fn=tick
        )
    )(params, state, x0, eps)
    u0_r, _, aux_r = jax.jit(
        lambda p, s, x, n: mppi_step(cfg, step_fn, stage, terminal, p, s, x, n)
    )(params, state, x0, eps)
    S_r = np.asarray(aux_r.costs)
    assert S_r.min() < 1e6, "degenerate all-colliding config — adjust the fuzz"
    np.testing.assert_allclose(
        np.asarray(aux_t.costs), S_r, rtol=5e-4, atol=5e-4
    )
    np.testing.assert_allclose(np.asarray(u0_t), np.asarray(u0_r), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("K_odd", [31, 33, 100])
def test_generic_k_padding_matches_scan(K_odd):
    """K that is not a multiple of the kernel's sample block: the wrapper
    pads ε to the block and slices the padded tail off S."""
    from dnn_mppi_mpc.ops.pallas.rollout import BLOCK_K

    assert K_odd % BLOCK_K != 0
    cfg = _cfg(5, 4, num_samples=K_odd)
    params = MPPIParams(
        sigma=jnp.asarray(np.diag([0.2, 0.2, 0.15, 0.15]), jnp.float32),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.full((4,), -2.0, jnp.float32),
        u_max=jnp.full((4,), 2.0, jnp.float32),
        ref_path=_path(3),
    )
    step_fn = lambda x, u: euler_step(four_wheel_torque, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, four_wheel_torque_tile(DT), stage)
    rng = np.random.default_rng(K_odd)
    eps = jnp.asarray(rng.multivariate_normal(np.zeros(4), np.asarray(params.sigma),
                                              (K_odd, T)), jnp.float32)
    x0 = jnp.array([0.1, -0.05, 0.2, 0.0, 0.0], jnp.float32)
    state = _state(cfg)
    out_k = mppi_step(cfg, step_fn, stage, terminal, params, state, x0, eps, rollout_fn=tick)
    out_r = mppi_step(cfg, step_fn, stage, terminal, params, state, x0, eps)
    assert out_k[2].costs.shape == (K_odd,)
    np.testing.assert_allclose(
        np.asarray(out_k[2].costs), np.asarray(out_r[2].costs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(np.asarray(out_k[0]), np.asarray(out_r[0]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "collision,moving",
    [
        ("none", False),
        ("circle", False),
        ("circle", True),
        ("soft", False),
        ("soft", True),
        ("polygon", False),
        ("polygon", True),
    ],
)
def test_kernel_matches_scan_per_collision_mode(collision, moving):
    """Every collision mode, with and without in-rollout obstacle drift, on
    the kinematic bicycle with wrap-yaw tracking and LAST accumulation."""
    cfg = _cfg(4, 2, accumulation=CostAccumulation.LAST)
    params = MPPIParams(
        sigma=jnp.array([[0.05, 0.0], [0.0, 0.3]], jnp.float32),
        stage_weight=jnp.array([6.0, 6.0, 2.0, 1.0], jnp.float32),
        terminal_weight=jnp.array([10.0, 10.0, 3.0, 1.0], jnp.float32),
        u_min=jnp.array([-0.5, -3.0], jnp.float32),
        u_max=jnp.array([0.5, 3.0], jnp.float32),
        ref_path=_path(4),
        obstacles=jnp.array([[2.0, 1.6, 0.4], [1.0, -1.2, 0.5]], jnp.float32),
        obstacle_velocities=(
            jnp.array([[-0.5, 0.2], [0.3, 0.4]], jnp.float32) if moving else None
        ),
    )
    bp = BicycleParams(wheel_base=jnp.asarray(2.5))
    step_fn = lambda x, u: euler_step(
        lambda x_, u_: kinematic_bicycle(x_, u_, bp), x, u, DT
    )
    stage, terminal = make_tracking_costs(
        cfg, wrap_yaw=True, collision=collision, robot_radius=0.3,
        vehicle_length=1.0, vehicle_width=0.6, safety_margin_rate=1.2,
        soft_safety_distance=1.0, soft_weight=30.0,
    )
    tick = _kernel(cfg, kinematic_bicycle_tile(DT, 2.5), stage)
    _run_both(cfg, params, step_fn, stage, terminal, tick,
              jnp.array([0.1, -0.05, -0.4, 1.0], jnp.float32), seed=11)


def test_kernel_fleet_per_member_paths_matches_scan():
    """A vmapped fleet (the kernel gains a grid axis per member) with its own
    reference path, state and ε per member equals per-member scan ticks."""
    cfg = _cfg(3, 2)
    base = MPPIParams(
        sigma=jnp.array([[0.2, 0.05], [0.05, 0.1]], jnp.float32),
        stage_weight=jnp.array([4.0, 4.0, 0.5], jnp.float32),
        terminal_weight=jnp.array([9.0, 9.0, 2.0], jnp.float32),
        u_min=jnp.array([-1.5, -2.0], jnp.float32),
        u_max=jnp.array([1.5, 2.0], jnp.float32),
        ref_path=_path(3),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, unicycle_tile(DT), stage)
    B = 3
    rng = np.random.default_rng(21)
    paths = jnp.stack([base.ref_path + 0.2 * b for b in range(B)])
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 3)), jnp.float32)
    eps = jnp.asarray(
        rng.multivariate_normal(np.zeros(2), np.asarray(base.sigma), (B, K, T)),
        jnp.float32,
    )
    state = _state(cfg)

    def member(path, x0, e, rollout_fn):
        p = dataclasses.replace(base, ref_path=path)
        return mppi_step(cfg, step_fn, stage, terminal, p, state, x0, e,
                         rollout_fn=rollout_fn)

    u_k, _, aux_k = jax.jit(jax.vmap(lambda *a: member(*a, tick)))(paths, x0s, eps)
    u_r, _, aux_r = jax.jit(jax.vmap(lambda *a: member(*a, None)))(paths, x0s, eps)
    np.testing.assert_allclose(
        np.asarray(aux_k.costs), np.asarray(aux_r.costs), rtol=3e-4, atol=3e-4
    )
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_r), rtol=1e-4, atol=1e-5)
