"""Differentiable NMPC: exact gradients through the whole controller.

The XLA-backend SQP solve (linearization → barrier-Riccati QP → merit line
search) plus plant rollout is one differentiable graph — a capability the
reference architecture cannot express (its tick crosses Python→acados-C→
libtorch boundaries, SURVEY §3.3). These tests pin that down:

* reverse-mode gradients of a closed-loop objective w.r.t. cost weights and
  the initial state match central finite differences (the fraction-to-
  boundary rule uses a double-where specifically to keep these finite —
  solvers/qp.py);
* a few Adam steps on the weights strictly decrease the closed-loop loss
  (the examples/nmpc_autotune.py loop at smoke scale).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import numpy as np

from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, NMPCState, OCPParams

_GOAL = jnp.array([1.5, 1.0, 0.5], jnp.float32)


def _solver(N=8, sqp_iters=1):
    cfg = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=0.1,
        sqp_iters=sqp_iters, qp_iters=6, qp_backend="xla",
    )
    return NMPCSolver(cfg, unicycle), cfg


def _params(qdiag, rdiag, N):
    return OCPParams(
        Q=jnp.diag(qdiag), R=jnp.diag(rdiag), Qe=jnp.diag(qdiag),
        yref=jnp.concatenate([_GOAL, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=_GOAL,
        lbx=jnp.full(3, -10.0), ubx=jnp.full(3, 10.0),
        # loose bounds: interior solution, so the objective is locally smooth
        # and finite differences are meaningful
        lbu=jnp.full(2, -5.0), ubu=jnp.full(2, 5.0),
    )


def _closed_loop_loss(solver, cfg, theta, x0, ticks=10):
    qdiag, rdiag = jnp.exp(theta[:3]), jnp.exp(theta[3:])
    op = _params(qdiag, rdiag, cfg.N)

    def body(carry, _):
        st, x = carry
        u0, st, _ = solver.solve_fn(differentiable=True)(op, st, x)
        x = solver.dyn_step(x, u0)
        return (st, x), (jnp.sum((x[:2] - _GOAL[:2]) ** 2), jnp.sum(u0**2))

    (_, xf), (track, effort) = jax.lax.scan(
        body, (NMPCState.init(cfg, x0), x0), None, length=ticks
    )
    return jnp.sum(track) + 0.01 * jnp.sum(effort)


@pytest.mark.slow
def test_weight_gradients_match_finite_differences():
    solver, cfg = _solver()
    x0 = jnp.array([0.2, -0.1, 0.0], jnp.float32)
    theta = jnp.log(jnp.array([10.0, 10.0, 0.1, 0.5, 0.05], jnp.float32))

    loss = jax.jit(lambda th: _closed_loop_loss(solver, cfg, th, x0))
    g = jax.jit(jax.grad(lambda th: _closed_loop_loss(solver, cfg, th, x0)))(theta)
    assert bool(jnp.all(jnp.isfinite(g)))

    e = 1e-2
    for i in range(theta.shape[0]):
        ei = jnp.zeros_like(theta).at[i].set(e)
        fd = (float(loss(theta + ei)) - float(loss(theta - ei))) / (2 * e)
        np.testing.assert_allclose(
            float(g[i]), fd, rtol=5e-2, atol=5e-3,
            err_msg=f"theta[{i}]",
        )


def test_x0_gradient_matches_finite_differences():
    solver, cfg = _solver(sqp_iters=2)
    theta = jnp.log(jnp.array([10.0, 10.0, 0.1, 0.5, 0.05], jnp.float32))

    def loss(x0):
        return _closed_loop_loss(solver, cfg, theta, x0, ticks=6)

    x0 = jnp.array([0.3, -0.2, 0.1], jnp.float32)
    g = jax.jit(jax.grad(loss))(x0)
    assert bool(jnp.all(jnp.isfinite(g)))
    jl = jax.jit(loss)
    e = 1e-2
    for i in range(3):
        ei = jnp.zeros(3).at[i].set(e)
        fd = (float(jl(x0 + ei)) - float(jl(x0 - ei))) / (2 * e)
        np.testing.assert_allclose(
            float(g[i]), fd, rtol=5e-2, atol=5e-3, err_msg=f"x0[{i}]"
        )


@pytest.mark.slow
def test_pallas_backend_gradients_match_xla():
    """jax.grad through a qp_backend="pallas" tick (the custom_vjp recompute
    rule in ops/pallas/riccati_qp.py) matches the all-XLA graph's gradient —
    single tick and vmapped fleet (fleet kernel) alike."""
    import dataclasses

    cfgp = SQPConfig(
        N=6, dim_x=3, dim_u=2, dt=0.1,
        sqp_iters=1, qp_iters=6, qp_backend="pallas",
    )
    cfgx = dataclasses.replace(cfgp, qp_backend="xla")
    sp = NMPCSolver(cfgp, unicycle, interpret=True)
    sx = NMPCSolver(cfgx, unicycle)
    theta = jnp.log(jnp.array([10.0, 10.0, 0.1, 0.5, 0.05], jnp.float32))
    x0 = jnp.array([0.2, -0.1, 0.0], jnp.float32)

    def loss(core, th):
        op = _params(jnp.exp(th[:3]), jnp.exp(th[3:]), cfgp.N)

        def body(carry, _):
            st, x = carry
            u0, st, _ = core(op, st, x)
            x = sx.dyn_step(x, u0)
            return (st, x), jnp.sum((x[:2] - _GOAL[:2]) ** 2)

        (_, _), track = jax.lax.scan(
            body, (NMPCState.init(cfgp, x0), x0), None, length=6
        )
        return jnp.sum(track)

    lp = jax.jit(lambda th: loss(sp.solve_fn(), th))
    gp = jax.jit(jax.grad(lambda th: loss(sp.solve_fn(), th)))(theta)
    gx = jax.jit(jax.grad(lambda th: loss(sx.solve_fn(), th)))(theta)
    np.testing.assert_allclose(
        float(lp(theta)),
        float(jax.jit(lambda th: loss(sx.solve_fn(), th))(theta)),
        rtol=1e-4,
    )
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gx), rtol=2e-3, atol=1e-4)

    # vmapped fleet: grad flows through the fleet kernel's custom_vjp
    op = _params(jnp.exp(theta[:3]), jnp.exp(theta[3:]), cfgp.N)
    x0s = jnp.stack([x0, x0 + 0.1, x0 - 0.2])
    ops = jax.tree.map(lambda a: jnp.broadcast_to(a, (3,) + a.shape), op)

    def fleet_loss(solver, cfg, xs):
        sts = jax.vmap(lambda x: NMPCState.init(cfg, x))(xs)
        u0, _, _ = jax.vmap(solver.solve_fn())(ops, sts, xs)
        return jnp.sum(u0**2)

    gfp = jax.jit(jax.grad(lambda xs: fleet_loss(sp, cfgp, xs)))(x0s)
    gfx = jax.jit(jax.grad(lambda xs: fleet_loss(sx, cfgx, xs)))(x0s)
    np.testing.assert_allclose(np.asarray(gfp), np.asarray(gfx), rtol=2e-3, atol=1e-4)


def test_autotune_improves_closed_loop_loss():
    """Five Adam steps on deliberately poor weights cut the loss (the
    examples/nmpc_autotune.py loop at smoke scale)."""
    import optax

    solver, cfg = _solver()
    x0 = jnp.array([0.2, -0.1, 0.0], jnp.float32)
    theta = jnp.log(jnp.array([0.5, 0.5, 5.0, 3.0, 3.0], jnp.float32))
    opt = optax.adam(0.2)
    os_ = opt.init(theta)

    @jax.jit
    def step(th, os_):
        v, g = jax.value_and_grad(
            lambda t: _closed_loop_loss(solver, cfg, t, x0)
        )(th)
        up, os2 = opt.update(g, os_, th)
        return v, optax.apply_updates(th, up), os2

    v0 = None
    for _ in range(12):
        v, theta, os_ = step(theta, os_)
        v0 = float(v) if v0 is None else v0
    assert float(v) < 0.6 * v0, (v0, float(v))


def _active_qp():
    """A small QP with a tight h-row per stage, so the barrier is active."""
    import numpy as _np

    from dnn_mppi_mpc.solvers.qp import BoxedQPData

    N, nx, nu = 6, 3, 2
    rng = _np.random.default_rng(3)
    f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    qp = BoxedQPData(
        A=jnp.asarray(_np.tile(_np.eye(nx), (N, 1, 1)) + 0.05 * rng.normal(size=(N, nx, nx)), f64),
        B=jnp.asarray(0.3 * rng.normal(size=(N, nx, nu)), f64),
        c=jnp.asarray(0.05 * rng.normal(size=(N, nx)), f64),
        Q=jnp.asarray(_np.tile(_np.diag([2.0, 2.0, 0.5]), (N + 1, 1, 1)), f64),
        qx_base=jnp.asarray(0.3 * rng.normal(size=(N + 1, nx)), f64),
        R=jnp.asarray(_np.tile(_np.diag([0.5, 0.3]), (N, 1, 1)), f64),
        ru_base=jnp.asarray(0.2 * rng.normal(size=(N, nu)), f64),
        lbx=jnp.full((N + 1, nx), 2.0, f64),
        ubx=jnp.full((N + 1, nx), 2.0, f64),
        lbu=jnp.full((N, nu), 0.6, f64),
        ubu=jnp.full((N, nu), 0.6, f64),
        Jh=jnp.asarray(_np.tile(rng.normal(size=(1, 1, nx)), (N + 1, 1, 1)), f64),
        h0=jnp.full((N + 1, 1), 0.15, f64),
    )
    return qp, jnp.asarray([0.1, -0.2, 0.05], f64)


def _qp_loss(backward, qp):
    from dnn_mppi_mpc.ops.pallas.riccati_qp import make_vmappable_pallas_qp

    solve = make_vmappable_pallas_qp(12, 1.0e-1, 0.35, None, 0.0, True, backward)

    def loss(qxb, dx0_):
        dX, dU, _ = solve(qp._replace(qx_base=qxb), dx0_)
        return jnp.sum(dX**2) + jnp.sum(jnp.sin(dU))

    return loss


def test_ift_backward_matches_recompute_with_obstacles():
    """The IFT backward (one factorized adjoint solve at the solution,
    solvers/qp.py::ift_qp_vjp) must match the recompute rule (reverse-mode
    through the unrolled forward) — including active linearized obstacle
    rows, where the barrier Hessian has off-diagonal JhᵀhhJh blocks."""
    qp, dx0 = _active_qp()
    g_ift = jax.grad(_qp_loss("ift", qp), argnums=(0, 1))(qp.qx_base, dx0)
    g_rec = jax.grad(_qp_loss("recompute", qp), argnums=(0, 1))(qp.qx_base, dx0)
    np.testing.assert_allclose(
        np.asarray(g_ift[0]), np.asarray(g_rec[0]), rtol=2e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(g_ift[1]), np.asarray(g_rec[1]), rtol=2e-4, atol=1e-5
    )


@pytest.mark.parametrize("backward", ["ift", "recompute"])
def test_qp_kernel_gradient_matches_finite_differences(backward):
    """Both gradient rules of the QP kernel against central differences of
    the kernel's own forward (f64), along a random direction in (qx, dx0)."""
    qp, dx0 = _active_qp()
    loss = _qp_loss(backward, qp)
    g_q, g_x = jax.grad(loss, argnums=(0, 1))(qp.qx_base, dx0)
    rng = np.random.default_rng(9)
    vq = jnp.asarray(rng.normal(size=qp.qx_base.shape), qp.qx_base.dtype)
    vx = jnp.asarray(rng.normal(size=dx0.shape), dx0.dtype)
    e = 1e-5
    fd = (
        float(loss(qp.qx_base + e * vq, dx0 + e * vx))
        - float(loss(qp.qx_base - e * vq, dx0 - e * vx))
    ) / (2 * e)
    ad = float(jnp.sum(g_q * vq) + jnp.sum(g_x * vx))
    # the IFT rule is exact at a converged solve; 12 barrier iterations
    # leave a small residual, hence the relative tolerance
    np.testing.assert_allclose(ad, fd, rtol=2e-2, atol=1e-6)
