"""Envs tests: plants (delay/noise), wheel IK, obstacles, closed loop, data collection."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.envs import (
    Plant,
    ackermann_wheel_speeds,
    chase_obstacles,
    collect_residual_dataset,
    diff_drive_wheel_speeds,
    drift_obstacles,
    run_closed_loop,
)
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import euler_step


def test_plant_euler_matches_reference_update():
    # mppi_differential_drive.py:33-40 plant integration
    plant = Plant(unicycle, dt=0.1)
    st = plant.init(jnp.array([0.0, 0.0, 0.5]), dim_u=2)
    st = plant.step(st, jnp.array([2.0, 0.3]))
    want = np.array([0.2 * np.cos(0.5), 0.2 * np.sin(0.5), 0.5 + 0.03])
    np.testing.assert_allclose(np.asarray(st.x), want, rtol=1e-6)


def test_plant_input_delay():
    # models/vehicle.py:99-104 delay buffer: first commands act late
    plant = Plant(unicycle, dt=0.1, delay_steps=2)
    st = plant.init(jnp.zeros(3), dim_u=2)
    st = plant.step(st, jnp.array([1.0, 0.0]))  # buffered
    st = plant.step(st, jnp.array([1.0, 0.0]))  # buffered
    np.testing.assert_allclose(np.asarray(st.x), 0.0, atol=1e-8)  # still at rest
    st = plant.step(st, jnp.array([0.0, 0.0]))
    assert float(st.x[0]) > 0.05  # first buffered command finally acts


def test_plant_process_noise_reproducible():
    plant = Plant(unicycle, dt=0.1, process_noise_std=jnp.array([0.01, 0.01, 0.001]))
    st1 = plant.init(jnp.zeros(3), dim_u=2, key=jax.random.PRNGKey(7))
    st2 = plant.init(jnp.zeros(3), dim_u=2, key=jax.random.PRNGKey(7))
    a = plant.step(st1, jnp.array([1.0, 0.0]))
    b = plant.step(st2, jnp.array([1.0, 0.0]))
    np.testing.assert_allclose(np.asarray(a.x), np.asarray(b.x))
    assert abs(float(a.x[1])) > 0  # noise actually applied


def test_diff_drive_wheel_ik():
    # bullet_differential_drive_dnn.py:20-34 with L=0.5708
    w = np.asarray(diff_drive_wheel_speeds(jnp.asarray(1.0), jnp.asarray(0.5)))
    L = 0.5708
    np.testing.assert_allclose(w, [1 - 0.5 * L / 2, 1 + 0.5 * L / 2] * 2)


def test_ackermann_wheel_ik_straight_line():
    w = np.asarray(ackermann_wheel_speeds(jnp.asarray(2.0), jnp.asarray(0.0), 0.325, 0.2))
    np.testing.assert_allclose(w, 2.0)


def test_drift_and_chase_obstacles():
    init = jnp.array([[5.0, 4.0], [3.5, 3.5]])
    vel = 0.09 * jnp.array([[0.2, 0.1], [-0.1, 0.1]])
    at2 = np.asarray(drift_obstacles(init, vel, jnp.asarray(2.0)))
    np.testing.assert_allclose(at2, np.asarray(init) + 2 * np.asarray(vel), rtol=1e-6)

    chased = chase_obstacles(init, jnp.array([0.0, 0.0]), speed=1.0, dt=0.1)
    d0 = np.linalg.norm(np.asarray(init), axis=1)
    d1 = np.linalg.norm(np.asarray(chased), axis=1)
    assert np.all(d1 < d0)


def test_closed_loop_proportional_controller():
    """Closed loop with a P-controller reaches the goal; residual errors ~0
    when the nominal model equals the plant."""
    dt = 0.1
    goal = jnp.array([1.0, 0.0])
    step = lambda x, u: euler_step(unicycle, x, u, dt)

    def controller(cs, x):
        d = goal - x[:2]
        heading = jnp.arctan2(d[1], d[0])
        v = jnp.clip(jnp.linalg.norm(d), 0.0, 1.0)
        w = jnp.clip(2.0 * (heading - x[2]), -1.5, 1.5)
        return jnp.stack([v, w]), cs

    ep, _ = run_closed_loop(
        jax.jit(controller, static_argnums=()), step, None, jnp.zeros(3), 50,
        nominal_step=step,
    )
    assert float(jnp.linalg.norm(ep.states[-1][:2] - goal)) < 0.1
    np.testing.assert_allclose(np.asarray(ep.errors), 0.0, atol=1e-6)


def test_collect_residual_dataset_learns_model_error():
    """When the plant has a residual the nominal model lacks, errors capture it."""
    dt = 0.1
    nominal = lambda x, u: euler_step(unicycle, x, u, dt)
    # plant with a constant drift the nominal model doesn't know about
    drift = jnp.array([0.01, -0.02, 0.0])
    plant = lambda x, u: euler_step(unicycle, x, u, dt) + drift

    def controller_factory(key):
        u_rand = jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)

        def controller(cs, x):
            return u_rand, cs

        return controller, None

    def x0_sampler(key):
        return jax.random.uniform(key, (3,), minval=-1.0, maxval=1.0)

    ep = collect_residual_dataset(
        controller_factory, plant, nominal, x0_sampler, jax.random.PRNGKey(0), 8, 20
    )
    assert ep.states.shape == (160, 3)
    assert ep.controls.shape == (160, 2)
    np.testing.assert_allclose(
        np.asarray(ep.errors.mean(axis=0)), np.asarray(drift), atol=1e-6
    )


def test_lidar_scan_geometry():
    """Beam straight at a circle returns distance-to-surface; misses return max."""
    from dnn_mppi_mpc.envs.sensors import goal_relative_obs, lidar_scan

    pose = jnp.array([0.0, 0.0, 0.0])
    obstacles = jnp.array([[5.0, 0.0, 1.0]])
    # beam 0 of a 4-beam full-circle scan points along -pi (behind); use fov=0
    # trick: single forward beam
    ranges = lidar_scan(pose, obstacles, num_beams=1, max_range=20.0, fov=0.0)
    np.testing.assert_allclose(float(ranges[0]), 4.0, atol=1e-5)
    # rotated away → miss
    pose_away = jnp.array([0.0, 0.0, np.pi])
    ranges = lidar_scan(pose_away, obstacles, num_beams=1, max_range=20.0, fov=0.0)
    np.testing.assert_allclose(float(ranges[0]), 20.0)

    obs = goal_relative_obs(jnp.array([0.0, 0.0, 0.0]), jnp.array([3.0, 4.0, 0.5]))
    np.testing.assert_allclose(float(obs[0]), 5.0, atol=1e-6)
    np.testing.assert_allclose(float(obs[1]), np.arctan2(4, 3), atol=1e-6)


def test_episode_csv_roundtrip():
    import tempfile

    from dnn_mppi_mpc.utils.logging import load_episode_csv, save_episode_csv

    states = np.random.default_rng(0).normal(size=(12, 3))
    controls = np.random.default_rng(1).normal(size=(12, 2))
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/ep.csv"
        save_episode_csv(path, states, controls)
        s2, c2 = load_episode_csv(path, nx=3)
    np.testing.assert_allclose(s2, states)
    np.testing.assert_allclose(c2, controls)


def test_on_device_mppi_closed_loop_scan():
    """MPPI controller + plant as one on-device scan (zero host dispatch):
    a whole episode jits and tracks the reference."""
    from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
    from dnn_mppi_mpc.envs.closed_loop import mppi_controller
    from dnn_mppi_mpc.paths.generators import line
    from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs

    cfg = MPPIConfig(num_samples=128, horizon=10, dim_x=3, dim_u=2, dt=0.1)
    params = MPPIParams(
        sigma=jnp.eye(2) * 0.2,
        stage_weight=jnp.array([5.0, 5.0, 1.0]),
        terminal_weight=jnp.array([5.0, 5.0, 1.0]),
        u_min=jnp.array([-3.0, -3.0]),
        u_max=jnp.array([3.0, 3.0]),
        ref_path=line(jnp.zeros(2), jnp.array([5.0, 0.0]), 60),
    )
    step = lambda x, u: euler_step(unicycle, x, u, 0.1)
    solver = MPPISolver(cfg, step, *make_tracking_costs(cfg))
    controller = mppi_controller(solver, params)
    run = jax.jit(lambda cs, x0: run_closed_loop(controller, step, cs, x0, 100))
    ep, _ = run(solver.init(jax.random.PRNGKey(0)), jnp.zeros(3))
    states = np.asarray(ep.states)
    assert np.all(np.isfinite(states))
    # moved along the line without diverging laterally
    assert states[-1, 0] > 0.3
    assert np.abs(states[:, 1]).max() < 1.0


def test_on_device_nmpc_closed_loop_scan():
    from dnn_mppi_mpc.config import SQPConfig
    from dnn_mppi_mpc.envs.closed_loop import nmpc_controller
    from dnn_mppi_mpc.models.integrators import erk_step
    from dnn_mppi_mpc.solvers.sqp import NMPCSolver, OCPParams

    N = 10
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=8)
    solver = NMPCSolver(cfg, unicycle)
    goal = jnp.array([1.5, 1.0, 0.0])
    params = OCPParams(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        R=jnp.diag(jnp.array([0.2, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.full(3, -10.0),
        ubx=jnp.full(3, 10.0),
        lbu=jnp.full(2, -1.5),
        ubu=jnp.full(2, 1.5),
    )
    plant = lambda x, u: erk_step(unicycle, x, u, 0.1, num_steps=3)
    controller = nmpc_controller(solver, params)
    run = jax.jit(lambda cs, x0: run_closed_loop(controller, plant, cs, x0, 80))
    ep, _ = run(solver.init(jnp.zeros(3)), jnp.zeros(3))
    final = np.asarray(ep.states[-1])
    assert np.linalg.norm(final[:2] - np.asarray(goal[:2])) < 0.1


def test_metrics_streaming_from_jitted_loop():
    """jax.debug.callback streams per-tick metrics out of a running scan
    (SURVEY §5.5 — live telemetry the reference's print()-at-end lacks)."""
    from dnn_mppi_mpc.envs.closed_loop import run_closed_loop

    dt = 0.1
    goal = jnp.array([1.0, 0.5])
    step = lambda x, u: euler_step(unicycle, x, u, dt)

    def controller(cs, x):
        d = goal - x[:2]
        heading = jnp.arctan2(d[1], d[0])
        v = jnp.clip(jnp.linalg.norm(d), 0.0, 1.0)
        w = jnp.clip(2.0 * (heading - x[2]), -1.5, 1.5)
        return jnp.stack([v, w]), cs

    received = []

    def cb(tick, **metrics):
        received.append((tick, {k: float(v) for k, v in metrics.items()}))

    metric_fn = lambda x, u: {
        "dist": jnp.linalg.norm(x[:2] - goal),
        "u_norm": jnp.linalg.norm(u),
    }
    run = jax.jit(
        lambda cs, x0: run_closed_loop(
            controller, step, cs, x0, 40,
            metric_fn=metric_fn, metric_cb=cb, metric_every=5,
        )
    )
    ep, _ = run(None, jnp.zeros(3))
    jax.block_until_ready(ep.states)
    jax.effects_barrier()
    assert len(received) == 8  # ticks 0,5,...,35
    ticks = sorted(t for t, _ in received)
    assert ticks == [0, 5, 10, 15, 20, 25, 30, 35]
    by_tick = dict(received)
    # distance to goal must shrink over the episode
    assert by_tick[35]["dist"] < by_tick[0]["dist"]
    assert all("u_norm" in m for _, m in received)


def test_collect_resumable_checkpoints_and_matches(tmp_path):
    """Chunk-level resume: interrupted collection skips finished chunks and
    the result is bit-identical to an uninterrupted run (SURVEY §5.4)."""
    from dnn_mppi_mpc.envs.closed_loop import (
        collect_residual_dataset_resumable,
    )

    dt = 0.1
    nominal = lambda x, u: euler_step(unicycle, x, u, dt)
    drift = jnp.array([0.01, -0.02, 0.0])
    plant = lambda x, u: euler_step(unicycle, x, u, dt) + drift

    def controller_factory(key):
        u_rand = jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)
        return (lambda cs, x: (u_rand, cs)), None

    def x0_sampler(key):
        return jax.random.uniform(key, (3,), minval=-1.0, maxval=1.0)

    key = jax.random.PRNGKey(3)
    args = (controller_factory, plant, nominal, x0_sampler, key, 10, 12)

    d1 = str(tmp_path / "run1")
    ep_full = collect_residual_dataset_resumable(*args, out_dir=d1, series_per_chunk=4)
    assert ep_full.states.shape == (120, 3)
    import os

    chunks = sorted(os.listdir(d1))
    assert chunks == ["chunk_00000.npz", "chunk_00001.npz", "chunk_00002.npz"]

    # "crashed" run: only the first two chunks survived
    d2 = str(tmp_path / "run2")
    os.makedirs(d2)
    for c in chunks[:2]:
        import shutil

        shutil.copy(os.path.join(d1, c), os.path.join(d2, c))
    t0 = os.path.getmtime(os.path.join(d2, chunks[0]))
    ep_resumed = collect_residual_dataset_resumable(*args, out_dir=d2, series_per_chunk=4)
    # finished chunks were not recomputed (mtime untouched), data identical
    assert os.path.getmtime(os.path.join(d2, chunks[0])) == t0
    np.testing.assert_array_equal(np.asarray(ep_resumed.states), np.asarray(ep_full.states))
    np.testing.assert_array_equal(np.asarray(ep_resumed.errors), np.asarray(ep_full.errors))

def test_collect_resumable_invalidates_stale_cache(tmp_path):
    """A cached chunk from a different PRNG key or config tag must be
    recomputed, not silently returned (round-2 review finding)."""
    from dnn_mppi_mpc.envs.closed_loop import (
        collect_residual_dataset_resumable,
    )

    dt = 0.1
    nominal = lambda x, u: euler_step(unicycle, x, u, dt)
    plant = lambda x, u: euler_step(unicycle, x, u, dt) + jnp.array([0.01, 0.0, 0.0])

    def controller_factory(key):
        u_rand = jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)
        return (lambda cs, x: (u_rand, cs)), None

    def x0_sampler(key):
        return jax.random.uniform(key, (3,), minval=-1.0, maxval=1.0)

    d = str(tmp_path / "run")
    common = (controller_factory, plant, nominal, x0_sampler)
    ep_a = collect_residual_dataset_resumable(
        *common, jax.random.PRNGKey(0), 4, 6, out_dir=d, series_per_chunk=4
    )
    # same out_dir, different key: cache must be invalidated and recomputed
    ep_b = collect_residual_dataset_resumable(
        *common, jax.random.PRNGKey(1), 4, 6, out_dir=d, series_per_chunk=4
    )
    assert not np.array_equal(np.asarray(ep_a.states), np.asarray(ep_b.states))
    # fresh from key 1 with an empty dir must equal the key-1 rerun above
    d2 = str(tmp_path / "run2")
    ep_b2 = collect_residual_dataset_resumable(
        *common, jax.random.PRNGKey(1), 4, 6, out_dir=d2, series_per_chunk=4
    )
    np.testing.assert_array_equal(np.asarray(ep_b.states), np.asarray(ep_b2.states))

    # different config_tag with the same key likewise invalidates
    import os

    t0 = os.path.getmtime(os.path.join(d2, "chunk_00000.npz"))
    collect_residual_dataset_resumable(
        *common, jax.random.PRNGKey(1), 4, 6,
        out_dir=d2, series_per_chunk=4, config_tag="other-controller",
    )
    assert os.path.getmtime(os.path.join(d2, "chunk_00000.npz")) != t0


def test_metrics_writer_as_metric_cb(tmp_path):
    """The documented pairing run_closed_loop(metric_cb=MetricsWriter.write)
    must serialize the jax.Array metric values debug.callback delivers
    (round-2 review finding: json.dumps crashed on device arrays)."""
    import json

    from dnn_mppi_mpc.envs.closed_loop import run_closed_loop
    from dnn_mppi_mpc.utils.logging import MetricsWriter

    dt = 0.1
    step = lambda x, u: euler_step(unicycle, x, u, dt)
    controller = lambda cs, x: (jnp.array([0.5, 0.1]), cs)
    path = str(tmp_path / "metrics.jsonl")
    w = MetricsWriter(path)
    metric_fn = lambda x, u: {"speed": u[0], "pos": x[:2]}
    ep, _ = run_closed_loop(
        controller, step, None, jnp.zeros(3), 20,
        metric_fn=metric_fn, metric_cb=w.write, metric_every=10,
    )
    jax.block_until_ready(ep.states)
    jax.effects_barrier()
    w.close()
    lines = [json.loads(l) for l in open(path)]
    assert [r["step"] for r in lines] == [0, 10]
    assert all(isinstance(r["speed"], float) for r in lines)
    assert all(len(r["pos"]) == 2 for r in lines)


def test_sinusoid_obstacles_per_obstacle_scalars():
    """(n,) amplitudes are per-obstacle, not per-axis: the old trailing-axis
    broadcast was silently wrong at n == 2 and crashed otherwise
    (round-2 review finding)."""
    from dnn_mppi_mpc.envs.obstacles import sinusoid_obstacles

    centers = jnp.array([[0.0, 0.0, 0.5], [5.0, 1.0, 0.4], [2.0, -3.0, 0.3]])
    amps = jnp.array([1.0, 2.0, 0.5])
    omegas = jnp.array([1.0, 0.5, 2.0])
    t = jnp.asarray(0.7)
    out = np.asarray(sinusoid_obstacles(centers, amps, omegas, t))
    expect_off = np.asarray(amps) * np.sin(np.asarray(omegas) * 0.7)
    np.testing.assert_allclose(out[:, 0], np.asarray(centers[:, 0]) + expect_off, rtol=1e-6)
    np.testing.assert_allclose(out[:, 1], np.asarray(centers[:, 1]) + expect_off, rtol=1e-6)
    np.testing.assert_allclose(out[:, 2], np.asarray(centers[:, 2]))  # radii pass through

    # per-axis (n, 2) form still works
    amps2 = jnp.stack([amps, jnp.zeros(3)], axis=1)
    out2 = np.asarray(sinusoid_obstacles(centers, amps2, jnp.ones((3, 2)), t))
    np.testing.assert_allclose(out2[:, 1], np.asarray(centers[:, 1]))  # zero y-amp


def test_lidar_full_circle_has_unique_beams():
    """At fov=2π the endpoint beam duplicates beam 0 (−π ≡ +π); the sweep
    must be uniform with no double-counted rearward ray (round-2 review)."""
    from dnn_mppi_mpc.envs.sensors import lidar_scan

    pose = jnp.array([0.0, 0.0, 0.0])
    # one obstacle straight behind: exactly ONE beam should see it at range 2
    obs = jnp.array([[-3.0, 0.0, 1.0]])
    ranges = np.asarray(lidar_scan(pose, obs, num_beams=36))
    assert ranges.shape == (36,)
    hits = np.where(ranges < 9.99)[0]
    best = ranges[hits].min()
    np.testing.assert_allclose(best, 2.0, atol=1e-5)
    # the -π direction is sampled once: the closest-hit count at range≈2 is 1
    assert (np.abs(ranges - 2.0) < 1e-5).sum() == 1


def test_with_recovery_resets_wedged_controller():
    """Elastic recovery (SURVEY §5.3): a NaN-poisoned nominal sequence wedges
    the MPPI solver in hold-previous forever; the recovery wrapper detects
    the persistent status-2 ticks, emits the safe control, resets the
    nominal sequence, and the loop resumes solving."""
    import dataclasses

    from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
    from dnn_mppi_mpc.envs.closed_loop import recovery_init, with_recovery
    from dnn_mppi_mpc.models.dynamics import unicycle
    from dnn_mppi_mpc.models.integrators import euler_step
    from dnn_mppi_mpc.paths import line
    from dnn_mppi_mpc.solvers.mppi import (
        MPPIState,
        make_tracking_costs,
        mppi_step,
    )

    cfg = MPPIConfig(
        num_samples=64, horizon=8, dim_x=3, dim_u=2, dt=0.1,
        waypoint_search_len=10,
    )
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.0], [0.0, 0.1]], jnp.float32),
        stage_weight=jnp.array([5.0, 5.0, 1.0], jnp.float32),
        terminal_weight=jnp.array([5.0, 5.0, 1.0], jnp.float32),
        u_min=jnp.array([-2.0, -2.0], jnp.float32),
        u_max=jnp.array([2.0, 2.0], jnp.float32),
        ref_path=line(jnp.zeros(2), jnp.array([3.0, 1.0]), num_points=60),
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, cfg.dt)
    stage, terminal = make_tracking_costs(cfg)
    core = jax.jit(
        lambda s, x: mppi_step(cfg, step_fn, stage, terminal, params, s, x, None)
    )

    def controller_aux(cs, x):
        return core(cs, x)

    def reset_fn(cs):
        return MPPIState(
            u_prev=jnp.zeros_like(cs.u_prev),
            waypoint_idx=cs.waypoint_idx,
            key=cs.key,
        )

    ctrl = with_recovery(controller_aux, reset_fn, max_bad_ticks=3)

    # poison the LAST row of the nominal sequence: the receding-horizon
    # shift replicates it forever, so hold-previous alone stays wedged (a
    # leading-row NaN would be shifted out and self-heal)
    bad = MPPIState.init(cfg)
    bad = MPPIState(
        u_prev=bad.u_prev.at[-1, 0].set(jnp.nan),
        waypoint_idx=bad.waypoint_idx,
        key=bad.key,
    )
    rs = recovery_init(bad)
    x = jnp.array([0.0, 0.2, 0.0], jnp.float32)
    us = []
    for _ in range(10):
        u, rs = ctrl(rs, x)
        us.append(np.asarray(u))
        x = step_fn(x, u)
    assert int(rs.resets) >= 1
    # failed ticks emitted the safe (zero) control, never NaN
    assert np.all(np.isfinite(np.stack(us)))
    # after recovery the solver produces genuine (nonzero) controls again
    assert np.abs(us[-1]).sum() > 0
    assert bool(jnp.all(jnp.isfinite(rs.inner.u_prev)))


# ---------------------------------------------------------------------------
# WheelPlant — actuation-level diff-drive plant (envs/plants.py)
# ---------------------------------------------------------------------------


def test_wheel_plant_matches_unicycle_for_ideal_wheels():
    """gains=1, no lag/delay/slip: IK→FK roundtrip reduces to the unicycle
    Euler step (the forward twin of kinematics.diff_drive_wheel_speeds)."""
    from dnn_mppi_mpc.envs.plants import WheelPlant
    from dnn_mppi_mpc.models import euler_step, unicycle

    plant = WheelPlant(dt=0.1)
    x0 = jnp.array([0.3, -0.2, 0.7])
    u = jnp.array([1.2, 0.5])
    ps = plant.step_body(plant.init(x0), u)
    ref = euler_step(unicycle, x0, u, 0.1)
    np.testing.assert_allclose(np.asarray(ps.x), np.asarray(ref), atol=1e-6)


def test_wheel_plant_lag_delay_cap():
    from dnn_mppi_mpc.envs.plants import WheelPlant

    # delay: first command acts one tick late
    plant = WheelPlant(dt=0.1, delay_steps=1)
    ps = plant.step_body(plant.init(jnp.zeros(3)), jnp.array([2.0, 0.0]))
    assert float(ps.x[0]) == 0.0  # buffered, nothing moved yet
    ps = plant.step_body(ps, jnp.array([0.0, 0.0]))
    np.testing.assert_allclose(float(ps.x[0]), 0.2, atol=1e-6)

    # lag: one step moves only the first-order fraction of the command
    plant = WheelPlant(dt=0.1, tau=0.1)
    ps = plant.step_body(plant.init(jnp.zeros(3)), jnp.array([1.0, 0.0]))
    import math

    np.testing.assert_allclose(
        float(ps.x[0]), 0.1 * (1 - math.exp(-1.0)), atol=1e-6
    )

    # cap: wheel speeds clip before FK
    plant = WheelPlant(dt=0.1, wheel_speed_cap=1.0)
    ps = plant.step_body(plant.init(jnp.zeros(3)), jnp.array([5.0, 0.0]))
    np.testing.assert_allclose(float(ps.x[0]), 0.1, atol=1e-6)


def test_wheel_plant_wraps_yaw():
    """PyBullet reports wrapped yaw (getEulerFromQuaternion); so does the
    plant — an integrated yaw walking past ±π re-enters (−π, π]."""
    from dnn_mppi_mpc.envs.plants import WheelPlant

    plant = WheelPlant(dt=0.1)
    ps = plant.init(jnp.array([0.0, 0.0, 3.1]))
    ps = plant.step_body(ps, jnp.array([0.0, 1.0]))  # yaw 3.1+0.1 → wraps
    assert float(ps.x[2]) < 0.0


def test_wheel_plant_diff_gain_calibration():
    """common/diff execution gains scale the two FK modes independently
    (the recorded-run calibration handles of tests/test_golden_nmpc.py)."""
    from dnn_mppi_mpc.envs.plants import WheelPlant

    plant = WheelPlant(dt=0.1, common_gain=2.0, diff_gain=0.5)
    ps = plant.step_body(plant.init(jnp.zeros(3)), jnp.array([1.0, 1.0]))
    np.testing.assert_allclose(float(ps.x[0]), 0.2, atol=1e-5)  # 2×
    np.testing.assert_allclose(float(ps.x[2]), 0.05, atol=1e-5)  # 0.5×
