"""Race-car MPPI crosscheck against the reference's OWN class — strict.

Runs the reference's actual ``MPPIRacecarController._calc_control_input``
(controllers/mppi_race_car_obstacle.py:65-131) side by side with this
framework's ``presets.racecar_mppi`` under identical injected noise.

Unlike the diff-drive controller (whose in-cost waypoint search mutates
shared state per (k, t), making exact parallel equality impossible — see
test_reference_crosscheck.py), the race-car class is pure per tick: the
waypoint window is anchored once per tick at the observed state (:71,
update_prev_idx=True; lookups inside ``_c`` never update it, :174-191), so
per-tick *numeric* agreement to f32 rounding is achievable — and asserted.

One reference quirk matters: ``u = self.u_prev`` ALIASES the carried plan
(:67), and the in-place shift ``self.u_prev[:-1] = u[1:]`` (:127-128) runs
BEFORE ``return u[0]`` — the class therefore returns the SECOND control of
the updated plan (the head of the shifted sequence). The engine returns the
genuine first control and carries the same shifted sequence, so the exact
equivalence is:

    class returned u0  ==  engine state.u_prev[0] after the tick
    class self.u_prev  ==  engine state.u_prev          (elementwise)

Covered: per-tick lockstep equality over a lap arc (obstacles near the
track so the 1e10 polygon-collision indicator fires in live samples),
free-running closed-loop agreement (validates the waypoint-index and
sequence carries too), and the 9-point vehicle-outline collision indicator
on crafted near-miss poses.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "controllers")),
    reason="reference checkout not available",
)

K, T, DT = 100, 10, 0.05
SIGMA = np.array([[0.5, 0.0], [0.0, 0.1]])
# circle r=15 through (15, 0); obstacles just off the track so near-miss
# samples collide while the optimal corridor stays open
OBS = np.array([[12.0, 10.0, 1.0], [-8.0, 14.0, 1.0]])
TICKS = 60


def _load_reference_class():
    import matplotlib

    matplotlib.use("Agg")
    for p in (REF, os.path.join(REF, "controllers")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from controllers.mppi_race_car_obstacle import (  # noqa: E402
        MPPIRacecarController,
    )

    return MPPIRacecarController


def _make_reference():
    cls = _load_reference_class()
    ctrl = cls(
        delta_t=DT, wheel_base=2.5, max_steer_abs=0.523, max_accel_abs=2.0,
        horizon_step_T=T, number_of_samples_K=K,
        param_exploration=0.01, param_lambda=50.0, param_alpha=1.0,
        sigma=SIGMA.copy(), obstacle_circles=OBS.copy(),
        visualize_optimal_traj=False, visualze_sampled_trajs=False,
    )
    # 300-point circle: prev_idx + SEARCH_INDEX_LEN stays inside the table
    # for the arc driven here, so the reference's [prev, prev+200) slice and
    # the engine's clipped window are the same set of waypoints
    ctrl.ref_path = ctrl.generate_simple_trajectory(300, 15.0).astype(np.float32)
    return ctrl


def _make_engine(ref_path):
    import jax.numpy as jnp

    from dnn_mppi_mpc.presets import racecar_mppi

    return racecar_mppi(
        jnp.asarray(ref_path), num_samples=K, horizon=T, dt=DT,
        obstacles=jnp.asarray(OBS),
    )


def _noise(seed):
    rng = np.random.default_rng(seed)
    return [
        rng.multivariate_normal(np.zeros(2), SIGMA, size=(K, T)).astype(np.float32)
        for _ in range(TICKS)
    ]


def _clip(u):
    return np.clip(u, [-0.523, -2.0], [0.523, 2.0])


X0 = np.array([15.0, 0.0, np.pi / 2, 0.0], dtype=np.float32)


def test_per_tick_numeric_agreement():
    import jax.numpy as jnp

    ctrl = _make_reference()
    solver, params = _make_engine(ctrl.ref_path)
    noises = _noise(7)

    state = solver.init()
    x = X0.copy()
    worst_seq = 0.0
    worst_u0 = 0.0
    for t in range(TICKS):
        eps = noises[t]
        ctrl._calc_epsilon = lambda *a, **k: eps.copy()
        u_prev_in = ctrl.u_prev.copy()
        wp_in = ctrl.prev_waypoints_idx
        u0_ref, _, _, _ = ctrl._calc_control_input(x.copy())

        # lockstep: inject the reference's carried state into the engine
        state = dataclasses.replace(
            state,
            u_prev=jnp.asarray(u_prev_in, jnp.float32),
            waypoint_idx=jnp.asarray(wp_in, jnp.int32),
        )
        _, state, aux = solver.step(
            params, state, jnp.asarray(x, jnp.float32),
            noise=jnp.asarray(eps, jnp.float32),
        )
        # exact equivalences (see module docstring for the aliasing quirk)
        seq_diff = np.abs(ctrl.u_prev - np.asarray(state.u_prev)).max()
        u0_diff = np.abs(u0_ref - np.asarray(state.u_prev[0])).max()
        assert int(np.asarray(aux.waypoint_idx)) == ctrl.prev_waypoints_idx
        worst_seq = max(worst_seq, float(seq_diff))
        worst_u0 = max(worst_u0, float(u0_diff))

        x = ctrl._F(x, _clip(u0_ref.copy()).astype(np.float32))

    # f32 rounding through softmax/filter: observed ~1e-5; gate at 1e-3
    assert worst_seq < 1e-3, worst_seq
    assert worst_u0 < 1e-3, worst_u0
    # the run must have made progress along the lap (the carry advanced)
    assert ctrl.prev_waypoints_idx > 10


def test_free_running_closed_loops_track_each_other():
    """No state injection: both controllers carry their own u_prev and
    waypoint index for a lap arc — validates the carries themselves."""
    import jax.numpy as jnp

    ctrl = _make_reference()
    solver, params = _make_engine(ctrl.ref_path)
    noises = _noise(11)

    x_ref = X0.copy()
    traj_ref = []
    for t in range(TICKS):
        ctrl._calc_epsilon = lambda *a, **k: noises[t].copy()
        u0_ref, _, _, _ = ctrl._calc_control_input(x_ref.copy())
        x_ref = ctrl._F(x_ref, _clip(u0_ref.copy()).astype(np.float32))
        traj_ref.append(x_ref.copy())

    state = solver.init()
    x_e = X0.copy()
    traj_e = []
    for t in range(TICKS):
        _, state, _ = solver.step(
            params, state, jnp.asarray(x_e, jnp.float32),
            noise=jnp.asarray(noises[t], jnp.float32),
        )
        u0 = _clip(np.asarray(state.u_prev[0]))  # the control the class returns
        x_e = ctrl._F(x_e, u0.astype(np.float32))
        traj_e.append(x_e.copy())

    traj_ref = np.asarray(traj_ref)
    traj_e = np.asarray(traj_e)
    # identical noise + exact per-tick math → trajectories separate only by
    # f32 rounding amplified through the closed loop
    assert np.abs(traj_ref[:, :2] - traj_e[:, :2]).max() < 0.05, np.abs(
        traj_ref[:, :2] - traj_e[:, :2]
    ).max()


def test_polygon_collision_indicator_matches_reference():
    """The 9-point vehicle outline vs circles indicator, on crafted
    near-miss poses (mppi_race_car_obstacle.py:255-274)."""
    import jax.numpy as jnp

    from dnn_mppi_mpc.ops.costs import vehicle_polygon_collision

    ctrl = _make_reference()
    rng = np.random.default_rng(3)
    n = 400
    # poses scattered around the first obstacle at distances spanning the
    # vehicle half-diagonal, all yaw angles
    center = OBS[0, :2]
    r = rng.uniform(0.0, 6.0, n)
    th = rng.uniform(0, 2 * np.pi, n)
    poses = np.zeros((n, 4), dtype=np.float32)
    poses[:, 0] = center[0] + r * np.cos(th)
    poses[:, 1] = center[1] + r * np.sin(th)
    poses[:, 2] = rng.uniform(-np.pi, np.pi, n)
    poses[:, 3] = rng.uniform(0, 5, n)

    ours = np.asarray(
        vehicle_polygon_collision(
            jnp.asarray(poses), jnp.asarray(OBS), 4.0, 3.0, 1.5
        )
    )
    theirs = np.array([ctrl._is_collided(p) for p in poses], dtype=np.float32)
    agree = ours == theirs
    # exclude only razor-edge poses where f32 vs f64 rounding legitimately
    # flips the strict inequality; everything else must agree exactly
    if not agree.all():
        from dnn_mppi_mpc.ops.costs import _OUTLINE_X, _OUTLINE_Y  # noqa

        bad = np.where(~agree)[0]
        assert len(bad) <= 2, f"{len(bad)} disagreements: {poses[bad]}"
    assert theirs.sum() > 20  # the corpus exercises both outcomes
    assert (1 - theirs).sum() > 20
