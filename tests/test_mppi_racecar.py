"""Race-car MPPI parity (BASELINE config 3) — engine vs scalar oracle,
kinematic bicycle + polygon obstacle collision + λ softmax + padded MA filter.

Unlike the diff-drive quirk mode, the race-car reference's cost-side waypoint
search is pure per tick (mppi_race_car_obstacle.py:153 uses update=False), so
engine and oracle must agree to float tolerance under identical injected noise.
"""

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
from dnn_mppi_mpc.models.dynamics import BicycleParams, kinematic_bicycle
from dnn_mppi_mpc.models.integrators import euler_step
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.paths.generators import lemniscate_with_speed
from dnn_mppi_mpc.testing.oracle import OracleRacecarMPPI

K, T, DT = 100, 10, 0.05


def _make_pair(with_obstacles=True):
    ref_path = np.asarray(lemniscate_with_speed(10.0, 100), dtype=np.float64)
    obstacles = (
        np.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]]) if with_obstacles else np.zeros((0, 3))
    )
    cfg = MPPIConfig(
        num_samples=K,
        horizon=T,
        dim_x=4,
        dim_u=2,
        dt=DT,
        lam=50.0,
        alpha=1.0,
        exploration=0.01,
        temperature=Temperature.LAMBDA,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_PADDED,
        filter_window=10,
        waypoint_search_len=200,
    )
    params = MPPIParams(
        sigma=jnp.array([[0.5, 0.0], [0.0, 0.1]]),
        stage_weight=jnp.array([50.0, 50.0, 1.0, 20.0]),
        terminal_weight=jnp.array([50.0, 50.0, 1.0, 20.0]),
        u_min=jnp.array([-0.523, -2.0]),
        u_max=jnp.array([0.523, 2.0]),
        ref_path=jnp.asarray(ref_path),
        obstacles=jnp.asarray(obstacles) if with_obstacles else None,
    )
    bicycle = BicycleParams(wheel_base=jnp.asarray(2.5))
    step_fn = lambda x, u: euler_step(
        lambda s, a: kinematic_bicycle(s, a, bicycle), x, u, DT
    )
    stage, terminal = make_tracking_costs(
        cfg,
        wrap_yaw=True,
        collision="polygon" if with_obstacles else "none",
        vehicle_length=4.0,
        vehicle_width=3.0,
        safety_margin_rate=1.5,
    )
    solver = MPPISolver(cfg, step_fn, stage, terminal)
    oracle = OracleRacecarMPPI(
        ref_path=ref_path, dt=DT, K=K, T=T, obstacles=obstacles
    )
    return cfg, params, solver, oracle


def test_racecar_single_tick_matches_oracle():
    cfg, params, solver, oracle = _make_pair()
    rng = np.random.default_rng(11)
    eps = rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma), size=(K, T))
    x0 = np.asarray([10.0, 0.0, np.pi / 2, 3.0])

    u0_o, u_o, S_o = oracle.step(x0, eps)
    state = solver.init()
    u0_j, new_state, aux = solver.step(
        params, state, jnp.asarray(x0), noise=jnp.asarray(eps, jnp.float32)
    )
    np.testing.assert_allclose(np.asarray(aux.costs), S_o, rtol=3e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(u0_j), u0_o, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(new_state.u_prev), oracle.u_prev, rtol=1e-3, atol=1e-4
    )


def test_racecar_closed_loop_matches_oracle():
    cfg, params, solver, oracle = _make_pair()
    rng = np.random.default_rng(13)
    x_o = np.asarray([10.0, 0.0, np.pi / 2, 2.0])
    x_j = jnp.asarray(x_o)
    state = solver.init()
    bicycle = BicycleParams(wheel_base=jnp.asarray(2.5))
    for _ in range(10):
        eps = rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma), size=(K, T))
        u0_o, _, _ = oracle.step(x_o, eps)
        u0_j, state, _ = solver.step(params, state, x_j, noise=jnp.asarray(eps, jnp.float32))
        np.testing.assert_allclose(np.asarray(u0_j), u0_o, rtol=5e-3, atol=2e-3)
        x_o = oracle._transition(x_o, u0_o)
        x_j = euler_step(lambda s, a: kinematic_bicycle(s, a, bicycle), x_j, u0_j, DT)
    np.testing.assert_allclose(np.asarray(x_j), x_o, rtol=1e-3, atol=2e-3)


def test_racecar_collision_cost_dominates():
    """Samples that hit an obstacle must carry the collision penalty."""
    cfg, params, solver, oracle = _make_pair(with_obstacles=True)
    # obstacle directly ahead of a fast car: many rollouts collide
    x0 = np.array([4.0, 5.0, 0.0, 4.0])  # heading +x toward obstacle at (5,5)
    rng = np.random.default_rng(17)
    eps = rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma), size=(K, T))
    state = solver.init()
    _, _, aux = solver.step(params, state, jnp.asarray(x0), noise=jnp.asarray(eps, jnp.float32))
    S = np.asarray(aux.costs)
    assert (S > 1e6).any(), "no sample registered a collision penalty"


@pytest.mark.slow
def test_racecar_tracks_lemniscate_closed_loop():
    """Behavioral: the race car follows the lemniscate (cross-track bounded)
    over a sustained closed loop — the open-loop demo of
    mppi_race_car_obstacle.py:324-343 upgraded to feedback."""
    from dnn_mppi_mpc.presets import racecar_mppi
    from dnn_mppi_mpc.paths.generators import lemniscate_with_speed
    from dnn_mppi_mpc.models.dynamics import BicycleParams, kinematic_bicycle

    ref = lemniscate_with_speed(10.0, 200, speed=4.0)
    solver, params = racecar_mppi(ref, num_samples=512, horizon=20)
    bp = BicycleParams(wheel_base=jnp.asarray(2.5))
    step = lambda x, u: euler_step(
        lambda s, a: kinematic_bicycle(s, a, bp), x, u, 0.05
    )
    x = jnp.asarray(np.asarray(ref[0]), jnp.float32)
    state = solver.init(jax.random.PRNGKey(0))
    ref_np = np.asarray(ref)
    ctes = []
    for _ in range(250):
        u0, state, aux = solver.step(params, state, x)
        x = step(x, u0)
        d = np.min(np.linalg.norm(ref_np[:, :2] - np.asarray(x[:2])[None], axis=1))
        ctes.append(d)
    ctes = np.asarray(ctes)
    # stays on course: bounded cross-track error, no divergence
    assert ctes.max() < 2.0, f"max cross-track error {ctes.max():.2f}"
    assert ctes[-50:].mean() < 1.0, f"steady-state cte {ctes[-50:].mean():.2f}"
    # actually makes progress around the course
    assert float(jnp.abs(x[3])) > 0.5, "car stalled"
