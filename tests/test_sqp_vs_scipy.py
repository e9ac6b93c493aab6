"""Converged SQP vs scipy SLSQP on the full nonlinear OCP (acados-parity proxy).

acados itself cannot run in this image, so the ground truth for the nonlinear
program (multiple shooting, ERK dynamics equalities, box bounds) is scipy's
SLSQP on the dense formulation. Our engine at sqp_iters≫1 must match the
optimal controls to control-tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import erk_step
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, OCPParams

N, DT = 8, 0.1
NX, NU = 3, 2


def _dyn_np(x, u):
    return np.array([u[0] * np.cos(x[2]), u[0] * np.sin(x[2]), u[1]])


def _step_np(x, u):
    # ERK(4 stages, 3 substeps) — same discretization as the engine
    h = DT / 3
    for _ in range(3):
        k1 = _dyn_np(x, u)
        k2 = _dyn_np(x + 0.5 * h * k1, u)
        k3 = _dyn_np(x + 0.5 * h * k2, u)
        k4 = _dyn_np(x + h * k3, u)
        x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def _solve_scipy(x0, goal, Q, R, Qe, lbu, ubu):
    nz = N * (NX + NU)

    def unpack(z):
        X = np.concatenate([x0[None], z[: N * NX].reshape(N, NX)])
        U = z[N * NX :].reshape(N, NU)
        return X, U

    def fun(z):
        X, U = unpack(z)
        f = 0.0
        for i in range(N):
            e = X[i] - goal
            f += 0.5 * e @ Q @ e + 0.5 * U[i] @ R @ U[i]
        eT = X[N] - goal
        f += 0.5 * eT @ Qe @ eT
        return f

    def dyn_con(z):
        X, U = unpack(z)
        return np.concatenate([_step_np(X[i], U[i]) - X[i + 1] for i in range(N)])

    lo = np.concatenate([np.full(N * NX, -np.inf), np.tile(lbu, N)])
    hi = np.concatenate([np.full(N * NX, np.inf), np.tile(ubu, N)])
    res = scipy.optimize.minimize(
        fun,
        np.zeros(nz),
        method="SLSQP",
        bounds=list(zip(lo, hi)),
        constraints=[{"type": "eq", "fun": dyn_con}],
        options={"maxiter": 800, "ftol": 1e-12},
    )
    assert res.success, res.message
    return unpack(res.x)


@pytest.mark.slow
def test_converged_sqp_matches_scipy_on_nonlinear_ocp():
    x0 = np.array([0.0, 0.0, 0.0])
    goal = np.array([1.0, 0.6, 0.0])
    Q = np.diag([10.0, 10.0, 1.0])
    R = np.diag([1.0, 0.5])
    Qe = np.diag([20.0, 20.0, 2.0])
    lbu, ubu = np.array([-1.0, -1.0]), np.array([1.0, 1.0])

    X_ref, U_ref = _solve_scipy(x0, goal, Q, R, Qe, lbu, ubu)

    cfg = SQPConfig(N=N, dim_x=NX, dim_u=NU, dt=DT, sqp_iters=30, qp_iters=20)
    solver = NMPCSolver(cfg, unicycle)
    params = OCPParams(
        Q=jnp.asarray(Q),
        R=jnp.asarray(R),
        Qe=jnp.asarray(Qe),
        yref=jnp.concatenate([jnp.asarray(goal), jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=jnp.asarray(goal),
        lbx=jnp.full(NX, -100.0),
        ubx=jnp.full(NX, 100.0),
        lbu=jnp.asarray(lbu),
        ubu=jnp.asarray(ubu),
    )
    state = solver.init(jnp.asarray(x0))
    u0, state, aux = solver.solve(params, state, jnp.asarray(x0))

    # cost comparison is the robust criterion (flat minima can differ in z)
    def cost(X, U):
        f = 0.0
        for i in range(N):
            e = X[i] - goal
            f += 0.5 * e @ Q @ e + 0.5 * U[i] @ R @ U[i]
        eT = X[N] - goal
        return f + 0.5 * eT @ Qe @ eT

    c_ref = cost(X_ref, U_ref)
    c_ours = cost(np.asarray(aux.X), np.asarray(aux.U))
    defect = float(aux.defect)
    assert defect < 5e-3, defect
    assert c_ours < c_ref * 1.02 + 1e-4, (c_ours, c_ref)
    # and the actual control sequences should be close pointwise
    np.testing.assert_allclose(np.asarray(aux.U), U_ref, atol=0.08)


@pytest.mark.slow
def test_general_nonlinear_ls_mixed_xu_matches_scipy():
    """General NONLINEAR_LS over (x, u) — acados' cost_y_expr
    (mpc_differential_drive_obstacle_static.py:186-190) with a *genuinely
    mixed* residual: y couples u with x, so the Gauss-Newton cross blocks
    S = JuᵀWJx are nonzero and flow through the Riccati solve."""
    x0 = np.array([0.0, 0.0, 0.0])
    goal = np.array([0.8, 0.5, 0.0])
    w = np.array([10.0, 10.0, 1.0, 1.0, 0.5])
    W = np.diag(w)
    Qe = np.diag([20.0, 20.0, 2.0])
    lbu, ubu = np.array([-1.0, -1.0]), np.array([1.0, 1.0])

    def y_np(x, u):
        return np.array(
            [
                x[0],
                x[1],
                x[2],
                u[0] * (1.0 + 0.3 * x[2]),
                u[1] + 0.2 * x[0] * u[0],
            ]
        )

    yref = np.concatenate([goal, np.zeros(2)])

    # scipy ground truth on the dense NLP
    nz = N * (NX + NU)

    def unpack(z):
        X = np.concatenate([x0[None], z[: N * NX].reshape(N, NX)])
        U = z[N * NX :].reshape(N, NU)
        return X, U

    def fun(z):
        X, U = unpack(z)
        f = 0.0
        for i in range(N):
            e = y_np(X[i], U[i]) - yref
            f += 0.5 * e @ W @ e
        eT = X[N] - goal
        f += 0.5 * eT @ Qe @ eT
        return f

    def dyn_con(z):
        X, U = unpack(z)
        return np.concatenate([_step_np(X[i], U[i]) - X[i + 1] for i in range(N)])

    lo = np.concatenate([np.full(N * NX, -np.inf), np.tile(lbu, N)])
    hi = np.concatenate([np.full(N * NX, np.inf), np.tile(ubu, N)])
    res = scipy.optimize.minimize(
        fun,
        np.zeros(nz),
        method="SLSQP",
        bounds=list(zip(lo, hi)),
        constraints=[{"type": "eq", "fun": dyn_con}],
        options={"maxiter": 800, "ftol": 1e-12},
    )
    assert res.success, res.message
    X_ref, U_ref = unpack(res.x)

    def y_jax(x, u):
        return jnp.stack(
            [
                x[0],
                x[1],
                x[2],
                u[0] * (1.0 + 0.3 * x[2]),
                u[1] + 0.2 * x[0] * u[0],
            ]
        )

    cfg = SQPConfig(N=N, dim_x=NX, dim_u=NU, dt=DT, sqp_iters=40, qp_iters=20)
    solver = NMPCSolver(cfg, unicycle, y_fn=y_jax, y_e_fn=lambda x: x)
    params = OCPParams(
        Q=jnp.asarray(W),  # full W over the 5-dim residual in y_fn mode
        R=jnp.eye(NU),  # unused by the y_fn cost path
        Qe=jnp.asarray(Qe),
        yref=jnp.tile(jnp.asarray(yref)[None], (N, 1)),
        yref_e=jnp.asarray(goal),
        lbx=jnp.full(NX, -50.0),
        ubx=jnp.full(NX, 50.0),
        lbu=jnp.asarray(lbu),
        ubu=jnp.asarray(ubu),
    )
    st = solver.init(jnp.asarray(x0))
    u0, st, aux = solver.solve(params, st, jnp.asarray(x0))
    np.testing.assert_allclose(np.asarray(aux.U), U_ref, atol=2e-2)
    np.testing.assert_allclose(np.asarray(aux.X), X_ref, atol=2e-2)
    assert float(aux.defect) < 1e-4


def _erk_np(dyn_np, x, u, dt, num_steps=3):
    h = dt / num_steps
    for _ in range(num_steps):
        k1 = dyn_np(x, u)
        k2 = dyn_np(x + 0.5 * h * k1, u)
        k3 = dyn_np(x + 0.5 * h * k2, u)
        k4 = dyn_np(x + h * k3, u)
        x = x + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def _bicycle_np(x, u):
    L = 0.325
    return np.array(
        [
            x[3] * np.cos(x[2]),
            x[3] * np.sin(x[2]),
            x[3] * np.tan(u[0]) / L,
            u[1],
        ]
    )


def _solve_scipy_generic(dyn_np, x0, goal, Q, R, Qe, lbu, ubu, N, nx, nu, dt):
    nz = N * (nx + nu)

    def unpack(z):
        X = np.concatenate([x0[None], z[: N * nx].reshape(N, nx)])
        U = z[N * nx :].reshape(N, nu)
        return X, U

    def fun(z):
        X, U = unpack(z)
        f = 0.0
        for i in range(N):
            e = X[i] - goal
            f += 0.5 * e @ Q @ e + 0.5 * U[i] @ R @ U[i]
        eT = X[N] - goal
        return f + 0.5 * eT @ Qe @ eT

    def dyn_con(z):
        X, U = unpack(z)
        return np.concatenate(
            [_erk_np(dyn_np, X[i], U[i], dt) - X[i + 1] for i in range(N)]
        )

    lo = np.concatenate([np.full(N * nx, -np.inf), np.tile(lbu, N)])
    hi = np.concatenate([np.full(N * nx, np.inf), np.tile(ubu, N)])
    res = scipy.optimize.minimize(
        fun,
        np.zeros(nz),
        method="SLSQP",
        bounds=list(zip(lo, hi)),
        constraints=[{"type": "eq", "fun": dyn_con}],
        options={"maxiter": 1200, "ftol": 1e-12},
    )
    assert res.success, res.message
    return unpack(res.x), fun(res.x)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", ["unicycle", "bicycle"])
def test_converged_sqp_fuzz_random_ocps(family, seed):
    """Randomized-OCP fuzz for the converged SQP engine: random goals,
    diagonal weights, x0, and control bounds across two dynamics families
    must reach (or beat) scipy SLSQP's optimum on the dense NLP, with a tight
    multiple-shooting defect — the property-level version of the single
    hand-picked parity case above."""
    from dnn_mppi_mpc.models.dynamics import BicycleParams, kinematic_bicycle

    rng = np.random.default_rng(100 * (family == "bicycle") + seed)
    if family == "unicycle":
        nx, nu, dyn_np, dyn_jax = NX, NU, _dyn_np, unicycle
    else:
        nx, nu, dyn_np = 4, 2, _bicycle_np
        bp = BicycleParams(wheel_base=jnp.asarray(0.325))
        dyn_jax = lambda x, u: kinematic_bicycle(x, u, bp)

    x0 = rng.uniform(-0.3, 0.3, nx)
    goal = np.concatenate([rng.uniform(0.4, 1.0, 2), np.zeros(nx - 2)])
    Q = np.diag(rng.uniform(2.0, 15.0, nx))
    R = np.diag(rng.uniform(0.3, 1.5, nu))
    Qe = np.diag(rng.uniform(5.0, 25.0, nx))
    ub = rng.uniform(0.6, 1.2, nu)
    lbu, ubu = -ub, ub
    if family == "bicycle":
        lbu[0], ubu[0] = -0.4, 0.4  # keep tan(steer) in a sane regime

    (X_ref, U_ref), c_ref = _solve_scipy_generic(
        dyn_np, x0, goal, Q, R, Qe, lbu, ubu, N, nx, nu, DT
    )

    cfg = SQPConfig(N=N, dim_x=nx, dim_u=nu, dt=DT, sqp_iters=30, qp_iters=20)
    solver = NMPCSolver(cfg, dyn_jax)
    params = OCPParams(
        Q=jnp.asarray(Q),
        R=jnp.asarray(R),
        Qe=jnp.asarray(Qe),
        yref=jnp.concatenate([jnp.asarray(goal), jnp.zeros(nu)])[None, :].repeat(
            N, axis=0
        ),
        yref_e=jnp.asarray(goal),
        lbx=jnp.full(nx, -100.0),
        ubx=jnp.full(nx, 100.0),
        lbu=jnp.asarray(lbu),
        ubu=jnp.asarray(ubu),
    )
    state = solver.init(jnp.asarray(x0))
    u0, state, aux = solver.solve(params, state, jnp.asarray(x0))

    def cost(X, U):
        f = 0.0
        for i in range(N):
            e = X[i] - goal
            f += 0.5 * e @ Q @ e + 0.5 * U[i] @ R @ U[i]
        eT = X[N] - goal
        return f + 0.5 * eT @ Qe @ eT

    c_ours = cost(np.asarray(aux.X, np.float64), np.asarray(aux.U, np.float64))
    assert float(aux.defect) < 5e-3, float(aux.defect)
    assert np.all(np.asarray(aux.U) >= lbu[None] - 1e-3)
    assert np.all(np.asarray(aux.U) <= ubu[None] + 1e-3)
    assert c_ours < c_ref * 1.02 + 1e-4, (family, seed, c_ours, c_ref)
