"""waypoint_carry="rollout": the pure form of the reference's stateful lookup.

The reference's per-step cost calls _get_nearest_waypoint(update_prev_idx=True)
(mppi_differential_drive.py:228), mutating the shared window start across every
(k, t) evaluation. That mutation is what produces the reference demo's forward
progress — the nearest-waypoint cost itself has no progress term. The engine's
pure equivalent carries a monotone per-rollout window start through the scan
(MPPIConfig.waypoint_carry="rollout"), optionally persisting the furthest index
across ticks (waypoint_persist="max"). Exact parity against the numpy oracle in
the same mode; behavioral gain vs the tick-anchored default; scan-vs-kernel
parity for the GPU rollout kernel (per-sample carried index, masked
running-min over a pre-gathered carry window). The direct comparison against the
reference's own code runs in tests/test_reference_crosscheck.py.
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
from dnn_mppi_mpc.models import euler_step, unicycle
from dnn_mppi_mpc.paths.generators import line
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs, mppi_step
from dnn_mppi_mpc.testing.oracle import OracleMPPI

K, T, DT = 64, 10, 0.1


def _make(carry="rollout", persist="max", **kw):
    cfg = MPPIConfig(
        num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT,
        lam=1.0, alpha=0.2, exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.SUM,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=10,
        waypoint_search_len=20,
        waypoint_carry=carry, waypoint_persist=persist,
        compute_optimal_traj=False, **kw,
    )
    ref = np.asarray(line(jnp.zeros(2), jnp.array([10.0, -5.0]), 100), np.float64)
    params = MPPIParams(
        sigma=jnp.array([[0.1, 0.0], [0.0, 0.01]]),
        stage_weight=jnp.array([5.0, 5.0, 10.0]),
        terminal_weight=jnp.array([5.0, 5.0, 10.0]),
        u_min=jnp.array([-5.0, -3.14]),
        u_max=jnp.array([5.0, 3.14]),
        ref_path=jnp.asarray(ref, jnp.float32),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(cfg)
    solver = MPPISolver(cfg, step_fn, stage, terminal)
    oracle = OracleMPPI(
        ref_path=ref, dt=DT, K=K, T=T, faithful=False,
        waypoint_carry=carry, waypoint_persist=persist,
    )
    return cfg, params, solver, oracle, step_fn


def test_rollout_carry_matches_oracle():
    cfg, params, solver, oracle, step_fn = _make()
    rng = np.random.default_rng(11)
    x_o = np.zeros(3)
    x_j = jnp.zeros(3)
    state = solver.init()
    for _ in range(12):
        eps = rng.multivariate_normal(
            np.zeros(2), np.asarray(params.sigma), size=(K, T)
        )
        u0_o, _, S_o = oracle.step(x_o, eps)
        u0_j, state, aux = solver.step(
            params, state, x_j, noise=jnp.asarray(eps, jnp.float32)
        )
        np.testing.assert_allclose(
            np.asarray(aux.costs), S_o, rtol=5e-3, atol=5e-3
        )
        np.testing.assert_allclose(np.asarray(u0_j), u0_o, rtol=5e-3, atol=5e-4)
        # persisted window start must match too
        assert int(state.waypoint_idx) == oracle.prev_idx
        x_o = x_o + np.array(
            [u0_o[0] * np.cos(x_o[2]), u0_o[0] * np.sin(x_o[2]), u0_o[1]]
        ) * DT
        x_j = step_fn(x_j, u0_j)
    np.testing.assert_allclose(np.asarray(x_j), x_o, rtol=1e-3, atol=1e-3)


def test_rollout_carry_progresses_faster_than_tick_anchor():
    """The lookahead is the point: closed-loop progress toward the goal must
    beat the tick-anchored default substantially (the reference's own demo
    relies on this effect for its forward progress)."""
    goal = np.array([10.0, -5.0])

    def run(carry, persist):
        cfg, params, solver, _, step_fn = _make(carry=carry, persist=persist)
        x = jnp.zeros(3)
        state = solver.init(jax.random.PRNGKey(0))
        for _ in range(120):
            u0, state, aux = solver.step(params, state, x)
            x = step_fn(x, u0)
            # the persisted index is a deliberate lookahead — the end-of-path
            # status bit must keep judging the robot's own (tick-level) index,
            # which stays far from the end on this course (review finding)
            assert int(aux.status) & 1 == 0, (carry, persist, aux.waypoint_idx)
        return float(np.linalg.norm(np.asarray(x)[:2] - goal))

    d0 = np.linalg.norm(goal)
    d_tick = run("tick", "none")
    d_roll = run("rollout", "max")
    prog_tick = d0 - d_tick
    prog_roll = d0 - d_roll
    assert prog_roll > 2.0 * max(prog_tick, 1e-6), (prog_tick, prog_roll)


def _kernel(cfg, stage):
    from dnn_mppi_mpc.models import unicycle_tile
    from dnn_mppi_mpc.solvers.mppi import make_rollout_kernel

    return make_rollout_kernel(cfg, unicycle_tile(DT), stage.tracking_spec, interpret=True)


def test_rollout_carry_sharded_matches_unsharded():
    """The kernel's carried window under shard_map: each shard returns its
    furthest carried index and the persisted lookahead is their pmax — the
    sharded tick equals the one-device tick."""
    from dnn_mppi_mpc.parallel.sharding import make_sharded_mppi_step

    cfg, params, solver, _, step_fn = _make(persist="max")
    cfg = dataclasses.replace(cfg, num_samples=256)
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, stage)
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("k",))
    sharded = make_sharded_mppi_step(cfg, step_fn, stage, terminal, mesh, rollout_fn=tick)
    rng = np.random.default_rng(2)
    noise = jnp.asarray(
        rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma), size=(256, T)),
        jnp.float32,
    )
    x0 = jnp.asarray([0.5, -0.3, 0.0])
    st = solver.init()
    u_s, st_s, aux_s = sharded(params, st, x0, noise)
    u_1, st_1, aux_1 = mppi_step(
        cfg, step_fn, stage, terminal, params, st, x0, noise=noise, rollout_fn=tick
    )
    np.testing.assert_allclose(np.asarray(aux_s.costs), np.asarray(aux_1.costs), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(u_s), np.asarray(u_1), rtol=1e-6, atol=1e-7)
    assert int(st_s.waypoint_idx) == int(st_1.waypoint_idx)


@pytest.mark.parametrize("persist", ["none", "max"])
@pytest.mark.parametrize("num_samples", [128, 100])
@pytest.mark.parametrize("obstacles", [False, True])
def test_fused_tick_rollout_carry_matches_scan(persist, num_samples, obstacles):
    """The kernel's per-sample carried window == the scan path, tick for
    tick: costs, u0, carried waypoint index and status all agree over a
    closed loop that advances well past the initial window (K=100 also runs
    the kernel's padded sample tail; obstacles add the circle penalty)."""
    cfg, params, solver, _, step_fn = _make(persist=persist)
    cfg = dataclasses.replace(cfg, num_samples=num_samples)
    if obstacles:
        params = dataclasses.replace(
            params, obstacles=jnp.array([[3.0, -1.0, 0.4], [6.0, -3.5, 0.5]])
        )
    stage, terminal = make_tracking_costs(
        cfg, collision="circle" if obstacles else "none"
    )
    tick = _kernel(cfg, stage)

    rng = np.random.default_rng(0)
    st_s = solver.init()
    st_f = solver.init()
    x_s = jnp.zeros(3)
    x_f = jnp.zeros(3)
    for t in range(12):
        noise = jnp.asarray(
            rng.multivariate_normal(
                np.zeros(2), np.asarray(params.sigma), size=(num_samples, T)
            ),
            jnp.float32,
        )
        u0_s, st_s, aux_s = mppi_step(
            cfg, step_fn, stage, terminal, params, st_s, x_s, noise=noise
        )
        u0_f, st_f, aux_f = mppi_step(
            cfg, step_fn, stage, terminal, params, st_f, x_f, noise=noise,
            rollout_fn=tick,
        )
        np.testing.assert_allclose(
            np.asarray(aux_s.costs), np.asarray(aux_f.costs), rtol=2e-4, atol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(u0_s), np.asarray(u0_f), rtol=1e-4, atol=2e-4
        )
        assert int(st_s.waypoint_idx) == int(st_f.waypoint_idx), t
        assert int(aux_s.status) == int(aux_f.status)
        x_s = step_fn(x_s, u0_s)
        x_f = step_fn(x_f, u0_f)
    if persist == "max":
        # the persisted lookahead must actually have advanced the carry
        assert int(st_s.waypoint_idx) > 5


@pytest.mark.parametrize("carry_window_len", [30, 48])
def test_generic_tick_rollout_carry_matches_scan(carry_window_len):
    """Kernel carry parity on both window paths (the unrolled ≤32-row
    window and the in-kernel loop at 48 rows) against the scan engine."""
    cfg, params, solver, _, step_fn = _make(persist="max")
    cfg = dataclasses.replace(
        cfg, num_samples=128, carry_window_len=carry_window_len
    )
    stage, terminal = make_tracking_costs(cfg)
    tick = _kernel(cfg, stage)

    rng = np.random.default_rng(4)
    st_s = solver.init()
    st_f = solver.init()
    x_s = jnp.zeros(3)
    x_f = jnp.zeros(3)
    for t in range(8):
        noise = jnp.asarray(
            rng.multivariate_normal(
                np.zeros(2), np.asarray(params.sigma), size=(128, T)
            ),
            jnp.float32,
        )
        u0_s, st_s, aux_s = mppi_step(
            cfg, step_fn, stage, terminal, params, st_s, x_s, noise=noise
        )
        u0_f, st_f, aux_f = mppi_step(
            cfg, step_fn, stage, terminal, params, st_f, x_f, noise=noise,
            rollout_fn=tick,
        )
        np.testing.assert_allclose(
            np.asarray(aux_s.costs), np.asarray(aux_f.costs), rtol=2e-4, atol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(u0_s), np.asarray(u0_f), rtol=1e-4, atol=2e-4
        )
        assert int(st_s.waypoint_idx) == int(st_f.waypoint_idx), t
        x_s = step_fn(x_s, u0_s)
        x_f = step_fn(x_f, u0_f)


def test_config_validation():
    cfg, params, solver, _, step_fn = _make()
    stage, terminal = make_tracking_costs(cfg)
    bad = dataclasses.replace(cfg, waypoint_carry="bogus")
    with pytest.raises(ValueError, match="waypoint_carry"):
        mppi_step(
            bad, step_fn, stage, terminal, params, solver.init(),
            jnp.zeros(3), noise=jnp.zeros((K, T, 2), jnp.float32),
        )
