"""Randomized-configuration parity fuzzing: engine vs scalar oracle.

Each case draws random hyperparameters (weights, Σ, bounds, path, start pose)
and checks the jitted engine against the numpy oracle under identical injected
noise — broad-spectrum evidence beyond the fixed reference configs.
"""

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
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import euler_step
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.testing.oracle import OracleMPPI


@pytest.mark.parametrize("seed", range(6))
def test_random_config_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    K = int(rng.choice([32, 64, 128]))
    T = int(rng.choice([5, 10, 15]))
    dt = float(rng.uniform(0.03, 0.15))
    lam = float(rng.uniform(0.5, 3.0))
    alpha = float(rng.uniform(0.0, 0.9))
    exploration = float(rng.choice([0.0001, 0.1, 0.3]))
    s1, s2 = rng.uniform(0.05, 0.6, 2)
    rho = rng.uniform(-0.5, 0.5) * np.sqrt(s1 * s2)
    sigma = np.array([[s1, rho], [rho, s2]])
    weights = rng.uniform(0.5, 20.0, 3)
    tweights = rng.uniform(0.5, 20.0, 3)
    vmax = float(rng.uniform(1.0, 6.0))
    wmax = float(rng.uniform(0.5, 4.0))
    n_pts = int(rng.choice([40, 100]))
    # random smooth path
    t_path = np.linspace(0, 2 * np.pi, n_pts)
    px = np.cumsum(rng.uniform(0.05, 0.2, n_pts))
    py = np.sin(t_path * rng.uniform(0.5, 2.0)) * rng.uniform(0.5, 3.0)
    yaw = np.arctan2(np.gradient(py), np.gradient(px))
    path = np.stack([px, py, yaw], axis=1)
    x0 = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5)])
    search_len = int(rng.choice([10, 20, 50]))

    cfg = MPPIConfig(
        num_samples=K,
        horizon=T,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=lam,
        alpha=alpha,
        exploration=exploration,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=min(10, T),
        waypoint_search_len=search_len,
    )
    params = MPPIParams(
        sigma=jnp.asarray(sigma),
        stage_weight=jnp.asarray(weights),
        terminal_weight=jnp.asarray(tweights),
        u_min=jnp.array([-vmax, -wmax]),
        u_max=jnp.array([vmax, wmax]),
        ref_path=jnp.asarray(path),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, dt)
    solver = MPPISolver(cfg, step_fn, *make_tracking_costs(cfg))

    oracle = OracleMPPI(
        ref_path=path,
        dt=dt,
        K=K,
        T=T,
        lam=lam,
        alpha=alpha,
        exploration=exploration,
        sigma=sigma,
        stage_weight=weights,
        terminal_weight=tweights,
        max_speed=vmax,
        max_omega=wmax,
        search_len=search_len,
        faithful=False,
        filter_window=min(10, T),
    )

    state = solver.init()
    x_j = jnp.asarray(x0)
    x_o = x0.copy()
    for tick in range(4):
        eps = rng.multivariate_normal(np.zeros(2), sigma, size=(K, T))
        u0_o, _, S_o = oracle.step(x_o, eps)
        u0_j, state, aux = solver.step(params, state, x_j, noise=jnp.asarray(eps, jnp.float32))
        np.testing.assert_allclose(
            np.asarray(aux.costs), S_o, rtol=5e-4, atol=5e-3,
            err_msg=f"seed={seed} tick={tick} costs",
        )
        np.testing.assert_allclose(
            np.asarray(u0_j), u0_o, rtol=5e-3, atol=1e-3,
            err_msg=f"seed={seed} tick={tick} u0",
        )
        x_o = x_o + np.array(
            [u0_o[0] * np.cos(x_o[2]), u0_o[0] * np.sin(x_o[2]), u0_o[1]]
        ) * dt
        x_j = step_fn(x_j, u0_j)


@pytest.mark.parametrize("seed", range(4))
def test_random_config_fused_epilogue_tick_matches_scan(seed):
    """Fuzz the tick on the rollout kernel (XLA epilogue: filter, update,
    hold, shift) against the scan engine on random configs — random filter
    kind/window, temperature convention, Σ, bounds, obstacles. Interpret
    mode; injected noise for exactness."""
    from dnn_mppi_mpc.models import unicycle_tile
    from dnn_mppi_mpc.solvers.mppi import (
        MPPIState,
        make_rollout_kernel,
        mppi_step,
    )

    rng = np.random.default_rng(100 + seed)
    K = int(rng.choice([128, 256]))
    T = int(rng.choice([6, 11, 16]))
    dt = float(rng.uniform(0.03, 0.12))
    filt = SmoothingFilter(rng.choice(["ma_edge", "ma_padded", "savgol", "none"]))
    cfg = MPPIConfig(
        num_samples=K,
        horizon=T,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=float(rng.uniform(0.5, 2.0)),
        alpha=float(rng.uniform(0.0, 0.8)),
        exploration=float(rng.choice([0.0001, 0.2])),
        temperature=Temperature(rng.choice(["lambda", "exploration"])),
        filter=filt,
        filter_window=int(rng.integers(2, min(8, T))),
        savgol_polyorder=2,
        waypoint_search_len=int(rng.choice([6, 12])),
    )
    s1, s2 = rng.uniform(0.05, 0.4, 2)
    off = rng.uniform(-0.4, 0.4) * np.sqrt(s1 * s2)
    n_pts = 50
    path = np.stack(
        [
            np.cumsum(rng.uniform(0.05, 0.2, n_pts)),
            np.sin(np.linspace(0, 4, n_pts)) * rng.uniform(0.5, 2.0),
            np.zeros(n_pts),
        ],
        axis=1,
    ).astype(np.float32)
    params = MPPIParams(
        sigma=jnp.asarray([[s1, off], [off, s2]], jnp.float32),
        stage_weight=jnp.asarray(rng.uniform(0.5, 10.0, 3), jnp.float32),
        terminal_weight=jnp.asarray(rng.uniform(0.5, 10.0, 3), jnp.float32),
        u_min=jnp.asarray([-rng.uniform(1, 4), -rng.uniform(1, 3)], jnp.float32),
        u_max=jnp.asarray([rng.uniform(1, 4), rng.uniform(1, 3)], jnp.float32),
        ref_path=jnp.asarray(path),
        obstacles=(
            jnp.asarray(rng.uniform(0.5, 3.0, (2, 3)), jnp.float32)
            if rng.random() < 0.5
            else None
        ),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, dt)
    stage, terminal = make_tracking_costs(
        cfg, collision="none" if params.obstacles is None else "circle"
    )
    tick = make_rollout_kernel(
        cfg, unicycle_tile(dt), stage.tracking_spec, interpret=True
    )
    state = MPPIState(
        u_prev=jnp.asarray(rng.normal(0, 0.2, (T, 2)), jnp.float32),
        waypoint_idx=jnp.zeros((), jnp.int32),
        key=jax.random.PRNGKey(seed),
    )
    x0 = jnp.asarray(rng.uniform(-0.4, 0.4, 3), jnp.float32)
    eps = jnp.asarray(
        rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma), (K, T)),
        jnp.float32,
    )
    u0_t, st_t, aux_t = jax.jit(
        lambda p, s, x, n: mppi_step(
            cfg, step_fn, stage, terminal, p, s, x, n, rollout_fn=tick
        )
    )(params, state, x0, eps)
    u0_r, st_r, aux_r = jax.jit(
        lambda p, s, x, n: mppi_step(cfg, step_fn, stage, terminal, p, s, x, n)
    )(params, state, x0, eps)
    np.testing.assert_allclose(
        np.asarray(aux_t.costs), np.asarray(aux_r.costs), rtol=5e-4, atol=5e-3,
        err_msg=f"seed={seed}",
    )
    np.testing.assert_allclose(
        np.asarray(u0_t), np.asarray(u0_r), rtol=5e-4, atol=5e-4,
        err_msg=f"seed={seed}",
    )
    np.testing.assert_allclose(
        np.asarray(st_t.u_prev), np.asarray(st_r.u_prev), rtol=5e-4, atol=5e-4,
        err_msg=f"seed={seed}",
    )
    assert int(aux_t.status) == int(aux_r.status)
