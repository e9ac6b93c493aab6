"""Step-dependent dynamics F(x, u, t) through MPPI, CEM and the rollout kernel.

The pytorch_mppi spec's dynamics take the timestep
(`dynamics(states, actions, t)`, /root/reference/test/test_mppi_diff_obs.py:28-42);
``MPPIConfig.time_varying_dynamics`` (and the CEM twin) routes that third
argument — the int32 rollout step index — through every rollout path:

* scan engine: t from the horizon scan;
* GPU rollout kernel (CPU interpret): ``step_takes_t`` passes the loop
  index to the tile step;
* sampled-trajectory and optimal-trajectory re-rollouts.

The test model is a unicycle whose actuation decays with rollout time
(v_eff = v / (1 + 0.1·t·dt)) — genuinely time-varying, so any path that
dropped t would diverge immediately.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import (
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    Temperature,
)
from dnn_mppi_mpc.solvers.mppi import (
    MPPIState,
    make_rollout_kernel,
    make_tracking_costs,
    mppi_step,
    sampled_trajectories,
)

K, T, DT = 256, 10, 0.05


def dyn_tv(x, u, t):
    """Unicycle with time-decaying actuation — F(x, u, t)."""
    decay = 1.0 / (1.0 + 0.1 * t.astype(x.dtype) * DT)
    v = u[..., 0] * decay
    w = u[..., 1] * decay
    yaw = x[..., 2]
    return jnp.stack(
        [
            x[..., 0] + v * jnp.cos(yaw) * DT,
            x[..., 1] + v * jnp.sin(yaw) * DT,
            yaw + w * DT,
        ],
        axis=-1,
    )


def tile_tv(xs, vs, t):
    """dyn_tv in tile form (one array per state/control dimension)."""
    x, y, yaw = xs
    decay = 1.0 / (1.0 + 0.1 * t.astype(x.dtype) * DT)
    v, w = vs[0] * decay, vs[1] * decay
    return (x + v * jnp.cos(yaw) * DT, y + v * jnp.sin(yaw) * DT, yaw + w * DT)


def _cfg(**kw):
    base = dict(
        num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT,
        lam=0.8, alpha=0.3, exploration=0.25,
        temperature=Temperature.LAMBDA,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=5,
        waypoint_search_len=8, time_varying_dynamics=True,
        compute_optimal_traj=True,
    )
    base.update(kw)
    return MPPIConfig(**base)


def _params():
    n = 40
    path = np.stack(
        [np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)), np.zeros(n)], axis=1
    )
    return MPPIParams(
        sigma=jnp.asarray([[0.1, 0.0], [0.0, 0.05]], jnp.float32),
        stage_weight=jnp.asarray([5.0, 5.0, 1.0], jnp.float32),
        terminal_weight=jnp.asarray([5.0, 5.0, 1.0], jnp.float32),
        u_min=jnp.asarray([-2.0, -2.0], jnp.float32),
        u_max=jnp.asarray([2.0, 2.0], jnp.float32),
        ref_path=jnp.asarray(path, jnp.float32),
    )


def _noise(seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, 0.1, (K, T, 2)), jnp.float32)


def test_scan_uses_t_and_matches_manual_rollout():
    cfg = _cfg()
    params = _params()
    stage, terminal = make_tracking_costs(cfg)
    state = MPPIState.init(cfg)
    x0 = jnp.asarray([0.0, 0.2, 0.1], jnp.float32)
    noise = _noise()
    u0, state2, aux = mppi_step(
        cfg, dyn_tv, stage, terminal, params, state, x0, noise=noise
    )
    assert np.isfinite(np.asarray(u0)).all()

    # manual S for a few samples: v = clip(u_prev + eps) (exploit block),
    # cost = tracking + energy, with the SAME decaying dynamics
    from dnn_mppi_mpc.ops.waypoints import nearest_waypoint
    from dnn_mppi_mpc.solvers.mppi import CostContext

    wp, _ = nearest_waypoint(params.ref_path, x0[:2], jnp.int32(0), 8)
    ctx = CostContext(params=params, waypoint_start=wp)
    sig_inv = np.linalg.inv(np.asarray(params.sigma))
    gamma = cfg.gamma
    for k in (0, 3, K - 1):
        exploit = k < (1.0 - cfg.exploration) * K
        x = x0
        S = 0.0
        for t in range(T):
            e = noise[k, t]
            v = (state.u_prev[t] + e) if exploit else e
            v = jnp.clip(v, params.u_min, params.u_max)
            x = dyn_tv(x, v, jnp.int32(t))
            S += float(stage(x, jnp.int32(t), ctx))
            S += gamma * float(state.u_prev[t] @ jnp.asarray(sig_inv) @ v)
        S += float(terminal(x, ctx))
        np.testing.assert_allclose(float(aux.costs[k]), S, rtol=2e-4)

    # optimal_traj re-rollout also threads t: recompute from u_new
    u_new = np.concatenate(
        [np.asarray(state2.u_prev)[:1] * 0 + np.asarray(u0)[None],
         np.asarray(state2.u_prev)[:-1]], axis=0
    )  # unshift: u_new = [u0, shifted[:-1]]
    x = x0
    for t in range(T):
        x = dyn_tv(x, jnp.clip(jnp.asarray(u_new[t]), params.u_min, params.u_max),
                   jnp.int32(t))
        np.testing.assert_allclose(
            np.asarray(aux.optimal_traj[t]), np.asarray(x), atol=1e-5
        )


def test_generic_tick_parity_with_scan():
    cfg = _cfg(compute_optimal_traj=False)
    params = _params()
    stage, terminal = make_tracking_costs(cfg)
    state = MPPIState.init(cfg)
    x0 = jnp.asarray([0.0, 0.2, 0.1], jnp.float32)
    noise = _noise(3)

    u0_scan, st_scan, aux_scan = mppi_step(
        cfg, dyn_tv, stage, terminal, params, state, x0, noise=noise
    )

    tick = make_rollout_kernel(cfg, tile_tv, stage.tracking_spec, interpret=True)
    u0_f, st_f, aux_f = mppi_step(
        cfg, dyn_tv, stage, terminal, params, state, x0,
        noise=noise, rollout_fn=tick,
    )
    np.testing.assert_allclose(
        np.asarray(aux_scan.costs), np.asarray(aux_f.costs), rtol=2e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(u0_scan), np.asarray(u0_f), atol=2e-4
    )


def test_sampled_trajectories_thread_t():
    cfg = _cfg(compute_optimal_traj=False)
    params = _params()
    state = MPPIState.init(cfg)
    x0 = jnp.asarray([0.0, 0.2, 0.1], jnp.float32)
    noise = _noise(5)
    trajs = sampled_trajectories(
        cfg, dyn_tv, params, state, x0, noise, jnp.zeros((K,)), top_fraction=0.1
    )
    # manual twin for sample 0 (exploit block, u_prev = 0 → v = clip(eps))
    x = x0
    for t in range(T):
        v = jnp.clip(noise[0, t], params.u_min, params.u_max)
        x = dyn_tv(x, v, jnp.int32(t))
        np.testing.assert_allclose(np.asarray(trajs[0, t]), np.asarray(x), atol=1e-6)


def test_cem_time_varying():
    from dnn_mppi_mpc.solvers.cem import CEMConfig, CEMSolver

    cfg = CEMConfig(
        num_samples=128, horizon=8, dim_x=3, dim_u=2, dt=DT,
        num_iters=3, time_varying_dynamics=True,
    )
    params = _params()
    mcfg = _cfg()
    stage, terminal = make_tracking_costs(mcfg)
    solver = CEMSolver(cfg, dyn_tv, stage, terminal)
    state = solver.init()
    u0, state, aux = solver.step(params, state, jnp.zeros(3, jnp.float32))
    assert np.isfinite(np.asarray(u0)).all()
    assert np.isfinite(float(aux.best_cost))


def test_solver_guard_rejects_specialized_kernels():
    """MPPISolver with the kernel bound as its rollout takes t through the
    tile step: its tick equals the scan solver's on the same ε."""
    from dnn_mppi_mpc.solvers.mppi import MPPISolver

    cfg = _cfg(compute_optimal_traj=False)
    params = _params()
    stage, terminal = make_tracking_costs(cfg)
    kernel = MPPISolver(
        cfg, dyn_tv, stage, terminal,
        rollout_fn=make_rollout_kernel(cfg, tile_tv, stage.tracking_spec, interpret=True),
    )
    scan = MPPISolver(cfg, dyn_tv, stage, terminal, use_pallas=False)
    x0 = jnp.asarray([0.1, -0.1, 0.3], jnp.float32)
    noise = _noise(7)
    u_k, _, aux_k = kernel.step(params, kernel.init(), x0, noise)
    u_s, _, aux_s = scan.step(params, scan.init(), x0, noise)
    np.testing.assert_allclose(
        np.asarray(aux_k.costs), np.asarray(aux_s.costs), rtol=2e-4, atol=1e-3
    )
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_s), atol=2e-4)
