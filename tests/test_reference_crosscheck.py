"""Cross-check against the reference's OWN code (not a re-derivation).

When the reference checkout is present, run its actual
``MPPIAlgorithms._calc_input_control`` (controllers/mppi_differential_drive.py)
side by side with this framework's engine on the reference main's exact
configuration (:392-443), feeding both the SAME injected noise per tick.

Exact per-tick equality is impossible by design: the reference's cost lookup
mutates the shared ``prev_way_point_idx`` across every (k, t) evaluation
(:228), a sequential cross-sample coupling no parallel engine can replicate
(SURVEY §7 "hard parts"). What matters behaviorally — and is asserted here —
is the closed-loop effect of that mutation: the window creeping ahead is the
sole source of forward progress in the reference demo (the nearest-waypoint
cost has no progress term). The engine's pure ``waypoint_carry="rollout"`` +
``waypoint_persist="max"`` mode recovers that lookahead and must land within a
documented band of the reference's own progress; the tick-anchored default is
also measured to document why the mode exists.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "controllers")),
    reason="reference checkout not available",
)

K, T, DT = 100, 10, 0.1
GOAL = np.array([10.0, -5.0])
TICKS = 40


def _load_reference_class():
    import matplotlib

    matplotlib.use("Agg")
    for p in (REF, os.path.join(REF, "controllers")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from controllers.mppi_differential_drive import (  # noqa: E402
        MPPIAlgorithms,
        generate_point_trajectory,
    )

    return MPPIAlgorithms, generate_point_trajectory


def _noise_stream(seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.array([[0.1, 0.0], [0.0, 0.01]])
    return [
        rng.multivariate_normal(np.zeros(2), sigma, size=(K, T))
        for _ in range(TICKS)
    ]


def _run_reference(ref_path, noises):
    MPPIAlgorithms, _ = _load_reference_class()
    mppi = MPPIAlgorithms(
        DT, ref_path, 5.0, 3.14, K, T, 0.0001, 1.0, 0.2,
        np.array([[0.1, 0.0], [0.0, 0.01]]),
        np.array([5.0, 5.0, 10.0]), np.array([5.0, 5.0, 10.0]),
    )
    x = np.zeros(3)
    mvn = np.random.multivariate_normal
    try:
        for eps in noises:
            np.random.multivariate_normal = lambda *a, **k: eps
            u0, _, _, _ = mppi._calc_input_control(x)
            x = x + np.array(
                [u0[0] * np.cos(x[2]), u0[0] * np.sin(x[2]), u0[1]]
            ) * DT
    finally:
        np.random.multivariate_normal = mvn
    return x


def _run_engine(ref_path, noises, carry, persist):
    import jax.numpy as jnp

    from dnn_mppi_mpc.config import (
        CostAccumulation,
        MPPIConfig,
        MPPIParams,
        SmoothingFilter,
        Temperature,
    )
    from dnn_mppi_mpc.models import euler_step, unicycle
    from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs

    cfg = MPPIConfig(
        num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT,
        lam=1.0, alpha=0.2, exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        # the reference overwrites S[k] per stage (:124) — LAST quirk mode
        accumulation=CostAccumulation.LAST,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=10,
        waypoint_search_len=20,
        waypoint_carry=carry, waypoint_persist=persist,
        compute_optimal_traj=False,
    )
    params = MPPIParams(
        sigma=jnp.array([[0.1, 0.0], [0.0, 0.01]]),
        stage_weight=jnp.array([5.0, 5.0, 10.0]),
        terminal_weight=jnp.array([5.0, 5.0, 10.0]),
        u_min=jnp.array([-5.0, -3.14]),
        u_max=jnp.array([5.0, 3.14]),
        ref_path=jnp.asarray(ref_path, jnp.float32),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    solver = MPPISolver(cfg, step_fn, *make_tracking_costs(cfg))
    x = jnp.zeros(3)
    state = solver.init()
    for eps in noises:
        u0, state, _ = solver.step(params, state, x, noise=jnp.asarray(eps, jnp.float32))
        x = step_fn(x, u0)
    return np.asarray(x)


def test_closed_loop_progress_matches_reference_code():
    _, generate_point_trajectory = _load_reference_class()
    cx, cy, cyaw = generate_point_trajectory(np.zeros(2), GOAL)
    ref_path = np.array([cx, cy, cyaw]).T
    noises = _noise_stream(0)

    d0 = float(np.linalg.norm(GOAL))
    x_ref = _run_reference(ref_path, noises)
    x_roll = _run_engine(ref_path, noises, "rollout", "max")
    x_tick = _run_engine(ref_path, noises, "tick", "none")

    prog_ref = d0 - float(np.linalg.norm(x_ref[:2] - GOAL))
    prog_roll = d0 - float(np.linalg.norm(x_roll[:2] - GOAL))
    prog_tick = d0 - float(np.linalg.norm(x_tick[:2] - GOAL))

    assert prog_ref > 1.0, f"reference itself did not progress: {prog_ref}"
    # lookahead mode within a band of the reference's own progress
    # (measured ~0.8× on this protocol; the residual gap is the sequential
    # cross-sample coupling documented in the module docstring)
    assert 0.5 * prog_ref < prog_roll < 1.5 * prog_ref, (prog_ref, prog_roll)
    # the purified default progresses much less — the documented trade
    assert prog_tick < 0.5 * prog_ref, (prog_ref, prog_tick)
    # both stay near the path (cross-track sanity)
    for x in (x_ref, x_roll):
        cte = abs(float(x[1]) + 0.5 * float(x[0])) / np.sqrt(1.25)
        assert cte < 1.0, (x, cte)


def test_per_tick_strict_equality_goal_pose():
    """STRICT per-tick numeric agreement with the reference's own class.

    A single-row reference path makes the reference's stateful
    ``prev_way_point_idx`` mutation provably inert (``_get_nearest_waypoint``
    always returns row 0 — :200-218), so the one obstacle to exact agreement
    for the diff-drive class disappears and everything else — rollout
    dynamics, LAST-overwrite stage cost (:124), exploration split,
    energy term, 1/exploration softmax, edge-rescaled moving-average filter,
    in-place update + shift — is pinned to float tolerance against the
    reference's own code with identical injected noise.

    Forensic note (verified empirically here): the reference's ``u`` ALIASES
    ``self.u_prev`` (:90), so the in-place left shift (:163-164) happens
    BEFORE ``return u[0]`` — the reference demo applies the optimizer's
    SECOND control U*[1], and its returned sequence is the shifted one. The
    framework returns the textbook U*[0] and carries the shifted sequence in
    ``state.u_prev``; therefore ``state.u_prev`` must equal the reference's
    returned ``u`` exactly, and the reference-applied control equals
    ``state.u_prev[0]`` (MIGRATION.md "control-application quirk").
    """
    import jax.numpy as jnp

    from dnn_mppi_mpc.config import (
        CostAccumulation,
        MPPIConfig,
        MPPIParams,
        SmoothingFilter,
        Temperature,
    )
    from dnn_mppi_mpc.models import euler_step, unicycle
    from dnn_mppi_mpc.solvers.mppi import (
        MPPISolver,
        MPPIState,
        make_tracking_costs,
    )

    MPPIAlgorithms, _ = _load_reference_class()
    Kk, Tt, exploration = 64, 12, 0.1
    ref_path = np.array([[2.0, 1.0, 0.3]])
    sigma = np.array([[0.1, 0.0], [0.0, 0.01]])
    mppi = MPPIAlgorithms(
        DT, ref_path, 5.0, 3.14, Kk, Tt, exploration, 1.0, 0.2,
        sigma.copy(),
        np.array([5.0, 5.0, 10.0]), np.array([5.0, 5.0, 10.0]),
    )

    cfg = MPPIConfig(
        num_samples=Kk, horizon=Tt, dim_x=3, dim_u=2, dt=DT,
        lam=1.0, alpha=0.2, exploration=exploration,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.LAST,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=10,
        waypoint_search_len=20,
        compute_optimal_traj=False,
    )
    params = MPPIParams(
        sigma=jnp.asarray(sigma),
        stage_weight=jnp.array([5.0, 5.0, 10.0]),
        terminal_weight=jnp.array([5.0, 5.0, 10.0]),
        u_min=jnp.array([-5.0, -3.14]),
        u_max=jnp.array([5.0, 3.14]),
        ref_path=jnp.asarray(ref_path),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    solver = MPPISolver(cfg, step_fn, *make_tracking_costs(cfg))
    # f64 carry ⇒ the whole engine step runs f64 (mppi_step unifies dtypes
    # to u_prev's), matching the reference's numpy f64 exactly — needed for
    # bit-stable agreement of boundary-sensitive terms
    state = solver.init()
    state = MPPIState(
        u_prev=jnp.zeros((Tt, 2), jnp.float64),
        waypoint_idx=state.waypoint_idx,
        key=state.key,
    )

    rng = np.random.default_rng(7)
    x = np.zeros(3)
    mvn = np.random.multivariate_normal
    try:
        for tick in range(25):
            eps = rng.multivariate_normal(np.zeros(2), sigma, size=(Kk, Tt))
            np.random.multivariate_normal = lambda *a, **k: eps
            u0_ref, useq_ref, _, _ = mppi._calc_input_control(x.copy())
            _, state, _ = solver.step(
                params, state, jnp.asarray(x), noise=jnp.asarray(eps)
            )
            np.testing.assert_allclose(
                np.asarray(state.u_prev), np.asarray(useq_ref),
                rtol=1e-9, atol=1e-11,
                err_msg=f"tick {tick}: shifted sequences diverge",
            )
            # both sides apply the control the REFERENCE applies (the
            # post-shift first element — see the forensic note above)
            np.testing.assert_allclose(
                np.asarray(state.u_prev[0]), u0_ref, rtol=1e-9, atol=1e-11
            )
            x = x + np.array(
                [u0_ref[0] * np.cos(x[2]), u0_ref[0] * np.sin(x[2]), u0_ref[1]]
            ) * DT
    finally:
        np.random.multivariate_normal = mvn
    # sanity: the shared closed loop actually moved toward the goal pose
    assert np.linalg.norm(x[:2] - ref_path[0, :2]) < np.linalg.norm(ref_path[0, :2])


def test_per_tick_strict_equality_obstacles():
    """Same strict construction for the OBSTACLE class
    (controllers/mppi_differential_drive_obs.py): single-row path + circle
    obstacles pins the robot-circle collision indicator (radius 0.5 ×
    safety_margin_rate + obstacle radius, :301-313) against the reference's
    own code per tick. The penalty CONSTANT deliberately differs (reference
    1e10, engine 1e7 for f32 headroom — ops/costs.py): with the
    1/exploration softmax both flush collided samples' weights to exactly
    0.0, so the weights — and therefore the control sequences — agree to
    f32 resolution as long as the indicator geometry matches, which is
    precisely what this gates."""
    import importlib

    import jax.numpy as jnp

    from dnn_mppi_mpc.config import (
        CostAccumulation,
        MPPIConfig,
        MPPIParams,
        SmoothingFilter,
        Temperature,
    )
    from dnn_mppi_mpc.models import euler_step, unicycle
    from dnn_mppi_mpc.solvers.mppi import (
        MPPISolver,
        MPPIState,
        make_tracking_costs,
    )

    _load_reference_class()  # sets up sys.path + Agg
    obs_mod = importlib.import_module("controllers.mppi_differential_drive_obs")

    Kk, Tt, exploration = 64, 12, 0.1
    ref_path = np.array([[2.0, 1.0, 0.3]])
    sigma = np.array([[0.1, 0.0], [0.0, 0.01]])
    obstacles = np.array([[0.9, 0.55, 0.15], [1.5, 0.7, 0.2]])
    margin = 1.5
    mppi = obs_mod.MPPIAlgorithms(
        DT, ref_path, 5.0, 3.14, Kk, Tt, exploration, 1.0, 0.2,
        sigma.copy(),
        np.array([5.0, 5.0, 10.0]), np.array([5.0, 5.0, 10.0]),
        obstacles.copy(), margin,
    )

    cfg = MPPIConfig(
        num_samples=Kk, horizon=Tt, dim_x=3, dim_u=2, dt=DT,
        lam=1.0, alpha=0.2, exploration=exploration,
        temperature=Temperature.EXPLORATION,
        accumulation=CostAccumulation.LAST,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE, filter_window=10,
        waypoint_search_len=20,
        compute_optimal_traj=False,
    )
    params = MPPIParams(
        sigma=jnp.asarray(sigma),
        stage_weight=jnp.array([5.0, 5.0, 10.0]),
        terminal_weight=jnp.array([5.0, 5.0, 10.0]),
        u_min=jnp.array([-5.0, -3.14]),
        u_max=jnp.array([5.0, 3.14]),
        ref_path=jnp.asarray(ref_path),
        obstacles=jnp.asarray(obstacles),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(
        cfg, collision="circle", robot_radius=0.5, safety_margin_rate=margin
    )
    solver = MPPISolver(cfg, step_fn, stage, terminal)
    # f64 engine run (see the goal-pose test): boundary-exact collision
    # indicators vs the reference's f64 numpy
    state = solver.init()
    state = MPPIState(
        u_prev=jnp.zeros((Tt, 2), jnp.float64),
        waypoint_idx=state.waypoint_idx,
        key=state.key,
    )

    rng = np.random.default_rng(11)
    x = np.zeros(3)
    mvn = np.random.multivariate_normal
    saw_collision_tick = False
    try:
        for tick in range(25):
            eps = rng.multivariate_normal(np.zeros(2), sigma, size=(Kk, Tt))
            np.random.multivariate_normal = lambda *a, **k: eps
            u0_ref, useq_ref, _, _ = mppi._calc_input_control(x.copy())
            _, state, aux = solver.step(
                params, state, jnp.asarray(x), noise=jnp.asarray(eps)
            )
            if float(np.asarray(aux.costs).max()) > 1e6:
                saw_collision_tick = True
            # atol floor 1e-9: the deliberate penalty-constant difference
            # (1e7 vs 1e10) perturbs ρ/η rounding order at the ulp level
            np.testing.assert_allclose(
                np.asarray(state.u_prev), np.asarray(useq_ref),
                rtol=1e-9, atol=1e-9,
                err_msg=f"tick {tick}: shifted sequences diverge",
            )
            x = x + np.array(
                [u0_ref[0] * np.cos(x[2]), u0_ref[0] * np.sin(x[2]), u0_ref[1]]
            ) * DT
    finally:
        np.random.multivariate_normal = mvn
    # the construction must actually exercise the collision indicator
    assert saw_collision_tick, "no rollout ever collided — move the obstacles"
