"""NMPC golden gate against the reference's recorded acados run — full protocol.

The reference ships 4 149 ticks of (states, controls, errors) from its
acados-driven Husky data collection (train/bullet_mpc_differential_drive.py:
334-336, randomized-series protocol of :119-157). Round-4 forensics on that
trace (test_recorded_trace_forensics below, assertions run against the trace
itself) established what it actually contains:

* the acados solver produced exactly ONE new solution per series — 49
  control changes in 4 149 ticks, all at series starts; 98.8% of consecutive
  controls are bit-identical. The per-solve obstacle parameters were
  corrupted by an argument-order bug (collect_data_series receives 0.2 — the
  distance threshold — as ``obstacle_positions``, :331), after which every
  in-series solve failed and the loop reused the stale plan (the reference
  ignores acados statuses, mpc_differential_drive_obstacle_static.py:322-323);
* the recorded plant response is not a wheel-kinematics response: motion
  direction is decorrelated from the reported yaw (median offset 1.42 rad —
  nonholonomy violated), the robot moves while v ≈ 0, and the least-squares
  yaw gain against commanded ω is ≈ −0.002 (the wheel-speed/joint-velocity
  unit confusion at :81-85 under real-time physics, :248).

Consequences for gating:

* per-tick CONTROL accuracy against acados semantics is gated by the f64
  oracle lockstep suite (tests/test_oracle_nmpc.py) — strict, per tick, with
  active constraints — NOT by envelopes of this trace (which measure a
  frozen controller);
* what this trace CAN gate is the protocol: test_full_protocol_replay runs
  the complete 50-series randomized protocol (identical setpoint
  distributions, weights Q=diag(25,20,45)/R=I (acados Δt stage scaling),
  bounds, N=100, Ts=3.0, per-series 100-tick cap, 0.1 m stop threshold,
  :119-157, :265-297) through the actuation-level WheelPlant (wheel IK →
  lag/delay/slip → FK — the PyBullet loop's shape), and requires the engine
  to do at least as well as the recorded run on the recorded run's own
  success metrics, with 1.5× bands where the quantity is comparable.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REF = "/root/reference/saved_data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference saved_data not available"
)


def _trace():
    s = np.load(os.path.join(REF, "states_diff.npy"))
    c = np.load(os.path.join(REF, "controls_diff.npy"))
    e = np.load(os.path.join(REF, "errors_diff.npy"))
    return s, c, e


def _series_bounds(s, e):
    ref = s - e
    sb = np.where(np.any(np.abs(np.diff(ref, axis=0)) > 1e-9, axis=1))[0] + 1
    return np.concatenate([[0], sb, [len(s)]])


def test_recorded_trace_forensics():
    """Pin the structural findings the gating strategy rests on."""
    s, c, e = _trace()
    assert s.shape[0] == 4149

    # 50 series
    b = _series_bounds(s, e)
    assert len(b) - 1 == 50

    # one genuine solve per series: controls change only at series starts
    chg = np.where(np.any(np.diff(c, axis=0) != 0, axis=1))[0] + 1
    frozen_frac = 1.0 - len(chg) / (len(c) - 1)
    assert frozen_frac > 0.95, frozen_frac
    starts = set(b[:-1]) | set(b[:-1] + 1)
    assert all(int(i) in starts for i in chg), "changes not at series starts"

    # recorded "convergence": about half the series ended within ~0.1 m
    # (the break test ran on the pre-solve state; the recorded error rows
    # straddle the threshold by measurement ordering, hence the tolerance)
    ends = np.concatenate([b[1:-1] - 1, [len(s) - 1]])
    fin = np.linalg.norm(e[ends][:, :2], axis=1)
    assert 23 <= int((fin < 0.105).sum()) <= 28

    # plant response is not wheel-kinematic: motion direction vs yaw
    offs = []
    for i in range(50):
        a, bb = b[i], b[i + 1]
        d = np.diff(s[a:bb, :2], axis=0)
        m = np.linalg.norm(d, axis=1) > 0.05
        ang = np.arctan2(d[m, 1], d[m, 0]) - s[a:bb - 1][m, 2]
        offs.append((ang + np.pi) % (2 * np.pi) - np.pi)
    offs = np.concatenate(offs)
    assert np.percentile(np.abs(offs), 50) > 1.0  # holonomic drift

    # least-squares yaw response to commanded omega is ~dead
    dyaw = np.diff(s[:, 2])
    dyaw = (dyaw + np.pi) % (2 * np.pi) - np.pi
    w = c[:-1, 1]
    g_w = float((dyaw @ w) / (w @ w)) / 0.1
    assert abs(g_w) < 0.05, g_w


@pytest.mark.slow
def test_full_protocol_replay():
    """The complete 50-series randomized protocol, closed through the
    actuation-level WheelPlant, must beat the recorded run's own metrics."""
    import dataclasses

    from dnn_mppi_mpc.envs.plants import WheelPlant
    from dnn_mppi_mpc.presets import diff_drive_nmpc

    s_rec, c_rec, e_rec = _trace()
    b = _series_bounds(s_rec, e_rec)
    rec_lens = np.diff(b)
    ends = np.concatenate([b[1:-1] - 1, [len(s_rec) - 1]])
    rec_conv = int(
        (np.linalg.norm(e_rec[ends][:, :2], axis=1) < 0.105).sum()
    )  # ~25-26
    rec_ticks = int(rec_lens.sum())  # 4149
    rec_conv_len = np.median(rec_lens[rec_lens < 100])  # ticks-to-converge

    # recorded-run solver setup (train/bullet_mpc_differential_drive.py:265-297):
    # N=100, Ts=3.0 (shooting dt 0.03); acados scales STAGE costs by the
    # shooting interval and the terminal cost not at all — mirrored here.
    N, shoot_dt = 100, 3.0 / 100
    Q = np.diag([25.0, 20.0, 45.0])
    solver, params0 = diff_drive_nmpc(
        jnp.zeros(3), N=N, dt=shoot_dt, sqp_iters=1, qp_iters=20, ip_kappa=0.6
    )
    params0 = dataclasses.replace(
        params0,
        Q=jnp.asarray(shoot_dt * Q, jnp.float32),
        R=jnp.asarray(shoot_dt * np.eye(2), jnp.float32),
        Qe=jnp.asarray(Q, jnp.float32),
        lbx=jnp.array([-15.0, -15.0, -3.14]),
        ubx=jnp.array([15.0, 15.0, 3.14]),
        lbu=jnp.array([-10.0, -31.4]),
        ubu=jnp.array([10.0, 31.4]),
    )
    # actuation-level plant at the protocol's intended control period (one
    # shooting interval per applied control): wheel IK → first-order wheel
    # lag + 1-tick command delay + 3% slip → FK
    plant = WheelPlant(dt=shoot_dt, tau=0.05, delay_steps=1, slip=0.97)
    solve = solver._solve

    @jax.jit
    def run_series(params, ps, st):
        def body(carry, _):
            ps, st = carry
            u0, st, _ = solve(params, st, ps.x)
            ps = plant._step_body_impl(ps, u0)
            return (ps, st), (ps.x, u0)

        (ps, st), (xs, us) = jax.lax.scan(body, (ps, st), None, length=100)
        return xs, us

    rng = np.random.default_rng(0)
    x = jnp.zeros(3, jnp.float32)
    lens, conv, all_u, all_disp = [], 0, [], []
    for i in range(50):
        tt = i % 3  # the protocol's alternation (:129)
        if tt == 0:
            sref = rng.uniform([-10, -10, -np.pi], [10, 10, np.pi])
            cref = rng.uniform([-5, -np.pi / 2], [5, np.pi / 2])
        elif tt == 1:
            r = rng.uniform(5, 10)
            c = rng.uniform(-5, 5, 2)
            sref = np.array([r + c[0], c[1], 0.0])  # circle_trajectory(0, ·)
            cref = np.array([4.0, 1.57])
        else:
            sc = rng.uniform(5, 10)
            c = rng.uniform(-5, 5, 2)
            sref = np.array([sc + c[0], c[1], 0.0])  # lemniscate_trajectory(0, ·)
            cref = np.array([4.0, 1.57])
        params = dataclasses.replace(
            params0,
            yref=jnp.concatenate(
                [jnp.asarray(sref, jnp.float32), jnp.asarray(cref, jnp.float32)]
            )[None].repeat(N, 0),
            yref_e=jnp.asarray(sref, jnp.float32),
        )
        xs, us = run_series(params, plant.init(x), solver.init(x))
        xs, us = np.asarray(xs), np.asarray(us)
        d = np.linalg.norm(xs[:, :2] - sref[:2], axis=1)
        hit = np.where(d < 0.1)[0]
        n = int(hit[0]) + 1 if len(hit) else 100
        conv += int(len(hit) > 0)
        lens.append(n)
        all_u.append(us[:n])
        prev = np.concatenate([np.asarray(x)[None, :2], xs[: n - 1, :2]], 0)
        all_disp.append(np.linalg.norm(xs[:n, :2] - prev, axis=1))
        x = jnp.asarray(xs[n - 1], jnp.float32)

    u = np.concatenate(all_u)
    disp = np.concatenate(all_disp)
    lens = np.asarray(lens)

    assert np.isfinite(u).all() and np.isfinite(disp).all()
    # 1. at least as many series converge as the recorded run's 25/50
    assert conv >= rec_conv, (conv, rec_conv)
    # 2. total protocol ticks within 1.5x of the recorded 4149
    assert lens.sum() <= 1.5 * rec_ticks, lens.sum()
    # 3. converged series settle at least as fast (1.5x band) as recorded
    assert np.median(lens[lens < 100]) <= 1.5 * rec_conv_len
    # 4. controls respect the recorded run's box bounds (0.5% relaxed-barrier
    # extension tolerance — active bounds settle ~delta inside, transients
    # during state-box recovery may poke marginally past; solvers/qp.py)
    assert np.abs(u[:, 0]).max() <= 10.0 * 1.005
    assert np.abs(u[:, 1]).max() <= 31.4 * 1.005
    # 5. per-tick displacement stays physical: wheel-lagged v<=10 at dt=0.03
    assert disp.max() <= 10.0 * shoot_dt * 1.05
    # scale note (not a 1.5x band by design — the recorded 0.155 m/tick is a
    # frozen-controller crawl, see forensics): same order of magnitude
    assert 0.02 < np.percentile(disp, 50) < 0.3
