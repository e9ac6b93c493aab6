"""Preset constructors: every reference controller config builds and steps."""

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc import presets
from dnn_mppi_mpc.models.learned import MLP, make_residual_fn
from dnn_mppi_mpc.paths import lemniscate_with_speed, line


def test_diff_drive_mppi_preset():
    solver, params = presets.diff_drive_mppi(line(jnp.zeros(2), jnp.array([10.0, -5.0])))
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3))
    assert u0.shape == (2,) and np.all(np.isfinite(np.asarray(u0)))


def test_diff_drive_mppi_obstacles_preset():
    solver, params = presets.diff_drive_mppi(
        line(jnp.zeros(2), jnp.array([10.0, -5.0])),
        num_samples=256,
        horizon=20,
        obstacles=jnp.array([[3.0, -1.5, 0.5]]),
    )
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(aux.costs)))


def test_racecar_mppi_preset():
    ref = lemniscate_with_speed(10.0, 100)
    solver, params = presets.racecar_mppi(
        ref, obstacles=jnp.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]])
    )
    x0 = jnp.asarray(ref[0])
    u0, st, aux = solver.step(params, solver.init(), x0)
    assert u0.shape == (2,) and np.all(np.isfinite(np.asarray(u0)))


def test_goal_seeking_mppi_preset():
    solver, params = presets.goal_seeking_mppi(
        jnp.array([6.0, 6.0, 1.57]),
        num_samples=256,
        obstacles=jnp.array([[5.0, 4.0, 0.0], [3.5, 3.5, 0.0]]),
        obstacle_velocities=0.09 * jnp.array([[0.2, 0.1], [-0.1, 0.1]]),
    )
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(u0)))


def test_nmpc_presets_step():
    for maker, goal, x0 in [
        (presets.diff_drive_nmpc, jnp.array([3.0, 2.0, 0.0]), jnp.zeros(3)),
        (presets.racecar_nmpc, jnp.array([2.0, 1.0, 0.0, 0.0]), jnp.zeros(4)),
        (presets.four_wheel_nmpc, jnp.array([1.0, 0.5, 0.0, 0.0, 0.0]), jnp.zeros(5)),
    ]:
        solver, params = maker(goal, N=10)
        u0, st, aux = solver.solve(params, solver.init(x0), x0)
        assert np.all(np.isfinite(np.asarray(u0))), maker.__name__


def test_racecar_nmpc_dynamic_model():
    solver, params = presets.racecar_nmpc(
        jnp.array([1.0, 0.5, 0.0, 0.0]), N=10, dynamic_model=True
    )
    # dynamic_bicycle's control layout is (a, δ): accel bound ±2, steer ±0.4
    # — the preset shipped these swapped (round-2 review finding)
    np.testing.assert_allclose(np.asarray(params.ubu), [2.0, 0.4])
    np.testing.assert_allclose(np.asarray(params.lbu), [-2.0, -0.4])
    x0 = jnp.array([0.0, 0.0, 0.0, 0.5])
    u0, st, aux = solver.solve(params, solver.init(x0), x0)
    assert np.all(np.isfinite(np.asarray(u0)))
    assert abs(float(u0[1])) <= 0.4 + 1e-3  # steering stays physical


def test_dnn_nmpc_preset():
    model = MLP(out_dim=3, hidden=32, depth=1, zero_init_head=True)
    mp = model.init(jax.random.PRNGKey(0), jnp.ones((1, 5)))
    net = make_residual_fn(model, mp)
    solver, params = presets.dnn_nmpc(jnp.array([2.0, 1.0, 0.0]), net, N=8)
    u0, st, aux = solver.solve(params, solver.init(jnp.zeros(3)), jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(u0)))


def test_nmpc_preset_overrides_forwarded():
    """**overrides must reach SQPConfig — silently dropping e.g.
    qp_backend='pallas' was a real bug (round 2)."""
    import pytest

    from dnn_mppi_mpc.presets import (
        diff_drive_nmpc,
        four_wheel_nmpc,
        racecar_nmpc,
    )

    for ctor, nx in ((diff_drive_nmpc, 3), (racecar_nmpc, 4), (four_wheel_nmpc, 5)):
        solver, _ = ctor(jnp.zeros(nx), qp_backend="pallas")
        assert solver.cfg.qp_backend == "pallas", ctor.__name__
    with pytest.raises(TypeError):
        diff_drive_nmpc(jnp.zeros(3), not_a_config_field=1)


def test_pallas_presets_round_samples_to_lanes():
    """Presets keep the caller's K on the kernel path: the rollout kernel
    pads K to its sample block itself (ops/pallas/rollout.py), so no preset
    rounds K or hands the user an assertion."""
    goal = jnp.zeros(3)
    solver, _ = presets.goal_seeking_mppi(goal, use_pallas=True)  # default 1500
    assert solver.cfg.num_samples == 1500
    assert solver.rollout_fn is not None

    ref = np.zeros((30, 4), np.float32)
    solver, _ = presets.racecar_mppi(jnp.asarray(ref), use_pallas=True)  # 100
    assert solver.cfg.num_samples == 100
    assert solver.rollout_fn is not None

    path = np.zeros((30, 3), np.float32)
    solver, _ = presets.diff_drive_mppi(jnp.asarray(path), use_pallas=True)
    assert solver.cfg.num_samples == 100
    # on this CPU the default choice is the scan path
    solver, _ = presets.diff_drive_mppi(jnp.asarray(path))
    assert solver.rollout_fn is None


def test_mppi_preset_overrides_replace_any_field():
    """**overrides must be able to replace ANY MPPIConfig field — explicitly
    set defaults used to collide ('multiple values for keyword argument',
    round-2 review finding)."""
    from dnn_mppi_mpc.config import SmoothingFilter, Temperature

    path = jnp.zeros((20, 3))
    solver, _ = presets.diff_drive_mppi(
        path, filter_window=5, waypoint_search_len=7,
        temperature=Temperature.LAMBDA,
    )
    assert solver.cfg.filter_window == 5
    assert solver.cfg.waypoint_search_len == 7
    assert solver.cfg.temperature == Temperature.LAMBDA

    ref = jnp.zeros((20, 4))
    solver, _ = presets.racecar_mppi(ref, filter=SmoothingFilter.NONE)
    assert solver.cfg.filter == SmoothingFilter.NONE

    solver, _ = presets.goal_seeking_mppi(jnp.zeros(3), filter_window=11)
    assert solver.cfg.filter_window == 11
