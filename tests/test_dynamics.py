"""Unit tests: dynamics, integrators vs closed forms and the scalar reference math."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.models import (
    BicycleParams,
    DynamicBicycleParams,
    FourWheelParams,
    dynamic_bicycle,
    erk_step,
    euler_step,
    four_wheel_torque,
    kinematic_bicycle,
    rk4_step,
    rollout,
    unicycle,
)


def test_unicycle_matches_scalar_form():
    # controllers/mppi_differential_drive.py:182-198 Euler form
    x = jnp.array([1.0, 2.0, 0.3])
    u = jnp.array([1.5, 0.4])
    dt = 0.1
    nxt = euler_step(unicycle, x, u, dt)
    expected = np.array(
        [1.0 + 1.5 * np.cos(0.3) * dt, 2.0 + 1.5 * np.sin(0.3) * dt, 0.3 + 0.4 * dt]
    )
    np.testing.assert_allclose(np.asarray(nxt), expected, rtol=1e-6)


def test_unicycle_batched_broadcasts():
    x = jnp.ones((7, 5, 3))
    u = jnp.ones((7, 5, 2))
    assert unicycle(x, u).shape == (7, 5, 3)


def test_kinematic_bicycle_matches_scalar_form():
    # controllers/mppi_race_car_obstacle.py:200-214 (Euler with dt)
    params = BicycleParams(wheel_base=jnp.asarray(2.5))
    x = jnp.array([0.0, 0.0, 0.1, 3.0])
    u = jnp.array([0.2, 1.0])
    dt = 0.05
    nxt = euler_step(lambda s, a: kinematic_bicycle(s, a, params), x, u, dt)
    expected = np.array(
        [
            0.0 + 3.0 * np.cos(0.1) * dt,
            0.0 + 3.0 * np.sin(0.1) * dt,
            0.1 + 3.0 / 2.5 * np.tan(0.2) * dt,
            3.0 + 1.0 * dt,
        ]
    )
    np.testing.assert_allclose(np.asarray(nxt), expected, rtol=1e-6)


def test_four_wheel_torque_accelerations():
    # controllers/mpc_differential_dynamics.py:98-105
    p = FourWheelParams.default()
    x = jnp.array([0.0, 0.0, 0.0, 1.0, 0.0])
    u = jnp.array([1.0, 2.0, 3.0, 4.0])
    dx = four_wheel_torque(x, u, p)
    r, m = float(p.wheel_radius), float(p.mass)
    L, inertia = float(p.wheel_sep), float(p.inertia)
    assert np.isclose(float(dx[3]), r / (4 * m) * 10.0)
    assert np.isclose(float(dx[4]), r / (L * inertia) * ((1 + 3) - (2 + 4)) / 2)


def test_dynamic_bicycle_finite_at_rest():
    x = jnp.zeros((4,))
    u = jnp.array([1.0, 0.3])
    dx = dynamic_bicycle(x, u, DynamicBicycleParams.default())
    assert np.all(np.isfinite(np.asarray(dx)))


def test_rk4_matches_analytic_exponential():
    # dx/dt = -x has exact solution x0 * exp(-t); RK4 error O(dt^5) per step.
    f = lambda x, u: -x
    x = jnp.array([1.0])
    u = jnp.zeros((1,))
    dt = 0.1
    nxt = rk4_step(f, x, u, dt)
    np.testing.assert_allclose(float(nxt[0]), np.exp(-dt), rtol=1e-7)


def test_erk_substeps_improve_accuracy():
    f = lambda x, u: -x
    x = jnp.array([1.0])
    u = jnp.zeros((1,))
    dt = 1.0
    err1 = abs(float(rk4_step(f, x, u, dt)[0]) - np.exp(-1.0))
    err3 = abs(float(erk_step(f, x, u, dt, num_steps=3)[0]) - np.exp(-1.0))
    assert err3 < err1


def test_rollout_scan_matches_loop():
    step = lambda x, u: euler_step(unicycle, x, u, 0.1)
    x0 = jnp.array([0.0, 0.0, 0.0])
    us = jnp.array([[1.0, 0.1]] * 5)
    traj = rollout(step, x0, us)
    x = x0
    for t in range(5):
        x = step(x, us[t])
        np.testing.assert_allclose(np.asarray(traj[t]), np.asarray(x), rtol=1e-6)


# ---------------------------------------------------------------------------
# IRK (Gauss-Legendre collocation) — acados IRK parity
# (controllers/mpc_differential_dynamics.py:198)
# ---------------------------------------------------------------------------


def test_irk_linear_high_order_accuracy():
    """GL-4 collocation is order 8: one step on ẋ = Ax ≈ expm(A·dt)·x."""
    import scipy.linalg
    from dnn_mppi_mpc.models.integrators import irk_step

    A = np.array([[0.0, 1.0], [-2.0, -0.4]])
    f = lambda x, u: jnp.asarray(A) @ x
    x0 = jnp.array([1.0, -0.5])
    dt = 0.3
    got = irk_step(f, x0, jnp.zeros(1), dt, num_steps=1, newton_iters=6)
    want = scipy.linalg.expm(A * dt) @ np.asarray(x0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-8, atol=1e-10)


def test_irk_a_stable_where_rk4_diverges():
    """Stiff decay ẋ = −λ(x − u), λ·dt = 20: explicit RK4 blows up
    (|R(−20)| ≫ 1), Gauss-Legendre IRK is A-stable and contracts."""
    from dnn_mppi_mpc.models.integrators import irk_step, rk4_step

    lam = 200.0
    dt = 0.1
    f = lambda x, u: -lam * (x - u[..., :1])
    u = jnp.array([0.5])
    x_e = x_i = jnp.array([5.0])
    for _ in range(20):
        x_e = rk4_step(f, x_e, u, dt)
        x_i = irk_step(f, x_i, u, dt, num_steps=1, newton_iters=8)
    assert not np.isfinite(float(x_e[0])) or abs(float(x_e[0])) > 1e6
    np.testing.assert_allclose(float(x_i[0]), 0.5, atol=1e-3)


def test_irk_nmpc_stiff_tracks_where_erk_diverges():
    """NMPC on a stiff actuator model at the control dt: the ERK engine's
    rollout is unstable (non-finite → status 2 / huge defect) while the IRK
    engine tracks — the reason mpc_differential_dynamics.py:198 picks IRK."""
    import dataclasses

    from dnn_mppi_mpc.config import SQPConfig
    from dnn_mppi_mpc.solvers.sqp import NMPCSolver, OCPParams

    # x = (position, velocity-like fast state); fast pole λ = 150
    lam = 150.0
    f = lambda x, u: jnp.stack([x[..., 1], -lam * (x[..., 1] - u[..., 0])], axis=-1)
    N, dt = 10, 0.1
    goal = jnp.array([1.0, 0.0])

    def params_for(n):
        return OCPParams(
            Q=jnp.diag(jnp.array([5.0, 0.01])),
            R=jnp.eye(1) * 0.01,
            Qe=jnp.diag(jnp.array([5.0, 0.01])),
            yref=jnp.tile(jnp.concatenate([goal, jnp.zeros(1)])[None], (n, 1)),
            yref_e=goal,
            lbx=jnp.full(2, -50.0),
            ubx=jnp.full(2, 50.0),
            lbu=jnp.full(1, -5.0),
            ubu=jnp.full(1, 5.0),
        )

    base = SQPConfig(N=N, dim_x=2, dim_u=1, dt=dt, sqp_iters=2, num_rk4_steps=1)
    params = params_for(N)

    def run(cfg):
        solver = NMPCSolver(cfg, f)
        x = jnp.array([0.0, 0.0])
        st = solver.init(x)
        statuses = []
        for _ in range(25):
            u0, st, aux = solver.solve(params, st, x)
            # exact plant via many tiny substeps (ground truth)
            from dnn_mppi_mpc.models.integrators import erk_step

            x = erk_step(f, x, u0, dt, num_steps=50)
            statuses.append(int(aux.status))
        return x, statuses

    x_irk, st_irk = run(dataclasses.replace(base, integrator="irk"))
    np.testing.assert_allclose(float(x_irk[0]), 1.0, atol=0.05)
    assert all(s == 0 for s in st_irk)

    x_erk, st_erk = run(base)
    # the explicit engine must visibly fail: non-finite solves rejected
    # (status flag 2) or grossly off-target
    assert any(s == 2 for s in st_erk) or abs(float(x_erk[0]) - 1.0) > 0.5


def test_irk_broadcasts_over_batch():
    """IRK must honor the module contract that integrators broadcast over
    leading batch dims — it previously crashed on (B, nx) states
    (round-2 review finding)."""
    from dnn_mppi_mpc.models.integrators import discretize, irk_step

    f = lambda x, u: jnp.stack(
        [x[..., 1], -4.0 * x[..., 0] - 0.3 * x[..., 1] + u[..., 0]], axis=-1
    )
    xs = jnp.asarray(np.random.default_rng(0).normal(size=(7, 2)), jnp.float32)
    us = jnp.asarray(np.random.default_rng(1).normal(size=(7, 1)), jnp.float32)
    batched = irk_step(f, xs, us, 0.05)
    single = jnp.stack([irk_step(f, xs[i], us[i], 0.05) for i in range(7)])
    np.testing.assert_allclose(np.asarray(batched), np.asarray(single), rtol=1e-6)
    # shared control broadcasts too, and discretize forwards num_stages
    step2 = discretize(f, 0.05, method="irk", num_steps=2, num_stages=3)
    out = step2(xs, jnp.zeros((1,), jnp.float32))
    assert out.shape == xs.shape and bool(jnp.all(jnp.isfinite(out)))
