"""Parity: the barrier-Riccati QP GPU kernel vs solvers/qp.py (interpret).

The kernel (ops/pallas/riccati_qp.py) must reproduce ``barrier_qp_solve``
in f32 — same μ-schedule, damping, regularization, condensing roll — across
randomized stage-structured QPs with box bounds, h-rows, and cross terms,
plus end-to-end through the SQP engine (cfg.qp_backend='pallas').
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.ops.pallas.riccati_qp import pallas_barrier_qp_solve
from dnn_mppi_mpc.solvers.qp import BoxedQPData, barrier_qp_solve


def _random_qp(rng, N=12, nx=3, nu=2, n_h=0, with_S=False):
    f = jnp.float32

    def spd(n, scale=1.0):
        M = rng.normal(size=(n, n)) * 0.3
        return jnp.asarray(M @ M.T + scale * np.eye(n), f)

    A = jnp.asarray(
        np.stack([np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)) for _ in range(N)]),
        f,
    )
    B = jnp.asarray(0.2 * rng.normal(size=(N, nx, nu)), f)
    c = jnp.asarray(0.05 * rng.normal(size=(N, nx)), f)
    Q = jnp.stack([spd(nx) for _ in range(N + 1)])
    R = jnp.stack([spd(nu) for _ in range(N)])
    qxb = jnp.asarray(0.5 * rng.normal(size=(N + 1, nx)), f)
    rub = jnp.asarray(0.5 * rng.normal(size=(N, nu)), f)
    lbx = jnp.asarray(1.5 + 0.2 * rng.random(size=(N + 1, nx)), f)
    ubx = jnp.asarray(1.5 + 0.2 * rng.random(size=(N + 1, nx)), f)
    lbu = jnp.asarray(1.0 + 0.2 * rng.random(size=(N, nu)), f)
    ubu = jnp.asarray(1.0 + 0.2 * rng.random(size=(N, nu)), f)
    if n_h:
        Jh = jnp.asarray(rng.normal(size=(N + 1, n_h, nx)), f)
        h0 = jnp.asarray(1.0 + rng.random(size=(N + 1, n_h)), f)
    else:
        Jh = h0 = None
    S = jnp.asarray(0.1 * rng.normal(size=(N, nu, nx)), f) if with_S else None
    return BoxedQPData(
        A=A, B=B, c=c, Q=Q, qx_base=qxb, R=R, ru_base=rub,
        lbx=lbx, ubx=ubx, lbu=lbu, ubu=ubu, Jh=Jh, h0=h0, S=S,
    )


@pytest.mark.parametrize(
    "n_h,with_S", [(0, False), (2, False), (0, True), (2, True)]
)
def test_kernel_matches_xla_qp(n_h, with_S):
    rng = np.random.default_rng(0 if not with_S else 7)
    qp = _random_qp(rng, n_h=n_h, with_S=with_S)
    dx0 = jnp.asarray(0.2 * rng.normal(size=(3,)), jnp.float32)

    dX_r, dU_r, kkt_r = barrier_qp_solve(qp, dx0, num_iters=8, return_kkt=True)
    dX_k, dU_k, kkt_k = pallas_barrier_qp_solve(
        qp, dx0, num_iters=8, interpret=True
    )

    np.testing.assert_allclose(
        np.asarray(dU_k), np.asarray(dU_r), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(dX_k), np.asarray(dX_r), rtol=2e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        float(kkt_k), float(kkt_r), rtol=5e-2, atol=1e-4
    )


def test_kernel_four_wheel_dims():
    """nx=5/nu=4 — the four-wheel torque model's shape class
    (mpc_differential_dynamics.py:71-131)."""
    rng = np.random.default_rng(42)
    qp = _random_qp(rng, N=10, nx=5, nu=4, n_h=2, with_S=True)
    dx0 = jnp.asarray(0.1 * rng.normal(size=(5,)), jnp.float32)
    dX_r, dU_r = barrier_qp_solve(qp, dx0, num_iters=8)
    dX_k, dU_k, _ = pallas_barrier_qp_solve(qp, dx0, num_iters=8, interpret=True)
    np.testing.assert_allclose(
        np.asarray(dU_k), np.asarray(dU_r), rtol=3e-3, atol=3e-3
    )


@pytest.mark.slow
def test_kernel_fuzz_many_seeds():
    for seed in range(5):
        rng = np.random.default_rng(100 + seed)
        qp = _random_qp(rng, N=8, nx=2 + seed % 3, nu=1 + seed % 2, n_h=seed % 3)
        nx = qp.A.shape[1]
        dx0 = jnp.asarray(0.1 * rng.normal(size=(nx,)), jnp.float32)
        dX_r, dU_r = barrier_qp_solve(qp, dx0, num_iters=8)
        dX_k, dU_k, _ = pallas_barrier_qp_solve(qp, dx0, num_iters=8, interpret=True)
        np.testing.assert_allclose(
            np.asarray(dU_k), np.asarray(dU_r), rtol=3e-3, atol=3e-3,
            err_msg=f"seed {seed}",
        )


def test_sqp_engine_pallas_backend_closed_loop():
    """cfg.qp_backend='pallas' end-to-end: diff-drive obstacle NMPC tracks
    the same trajectory as the XLA backend."""
    from dnn_mppi_mpc.models.dynamics import unicycle
    from dnn_mppi_mpc.presets import diff_drive_nmpc
    from dnn_mppi_mpc.solvers.sqp import NMPCSolver, circle_obstacle_h

    obs = jnp.array([[2.0, 0.6, 0.5]], jnp.float32)
    goal = jnp.array([4.0, 0.0, 0.0], jnp.float32)
    solver_x, params = diff_drive_nmpc(goal, N=20, obstacles=obs)
    cfg_p = dataclasses.replace(solver_x.cfg, qp_backend="pallas")
    solver_p = NMPCSolver(cfg_p, unicycle, h_fn=circle_obstacle_h, interpret=True)

    def drive(solver):
        x = jnp.zeros(3, jnp.float32)
        st = solver.init(x)
        for _ in range(40):
            u0, st, aux = solver.solve(params, st, x)
            x = solver.dyn_step(x, u0)
        return np.asarray(x), float(aux.h_margin)

    x_x, hm_x = drive(solver_x)
    x_p, hm_p = drive(solver_p)
    # both reach the goal, respecting the obstacle
    assert np.linalg.norm(x_p[:2] - np.asarray(goal[:2])) < 0.3, x_p
    assert hm_p > -1e-3
    np.testing.assert_allclose(x_p, x_x, rtol=0.05, atol=0.05)


def test_sqp_engine_pallas_backend_four_wheel():
    """qp_backend='pallas' on the four-wheel torque model (nx=5, nu=4,
    mpc_differential_dynamics.py) — the largest stage dims in the suite."""
    from dnn_mppi_mpc.models.dynamics import four_wheel_torque
    from dnn_mppi_mpc.presets import four_wheel_nmpc
    from dnn_mppi_mpc.solvers.sqp import NMPCSolver

    goal = jnp.array([1.0, 0.5, 0.0, 0.0, 0.0], jnp.float32)
    solver_x, params = four_wheel_nmpc(goal, N=20, sqp_iters=2, qp_iters=10)
    cfg_p = dataclasses.replace(solver_x.cfg, qp_backend="pallas")
    solver_p = NMPCSolver(cfg_p, four_wheel_torque, interpret=True)

    def drive(solver):
        x = jnp.zeros(5, jnp.float32)
        st = solver.init(x)
        for _ in range(80):
            u0, st, aux = solver.solve(params, st, x)
            x = solver.dyn_step(x, u0)
        return np.asarray(x)

    x_p = drive(solver_p)
    x_x = drive(solver_x)
    assert np.linalg.norm(x_p[:2] - np.asarray(goal[:2])) < 0.15, x_p
    np.testing.assert_allclose(x_p, x_x, rtol=0.05, atol=0.08)


# ---------------------------------------------------------------------------
# Fleet kernel (one fleet member per thread, BLOCK_B members per program)
# ---------------------------------------------------------------------------


def _stack_qps(qps):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *qps)


@pytest.mark.parametrize(
    "n_h,with_S", [(0, False), (2, False), (2, True)]
)
def test_batched_kernel_matches_per_problem(n_h, with_S):
    """Each member of the fleet kernel reproduces the single-problem solve on
    that member's QP (distinct problems per member, incl. h-rows and S)."""
    from dnn_mppi_mpc.ops.pallas.riccati_qp import (
        pallas_batched_barrier_qp_solve,
    )

    B = 5
    qps = [
        _random_qp(np.random.default_rng(10 + i), N=8, nx=3, nu=2,
                   n_h=n_h, with_S=with_S)
        for i in range(B)
    ]
    rng = np.random.default_rng(3)
    dx0 = jnp.asarray(0.2 * rng.normal(size=(B, 3)), jnp.float32)

    dXb, dUb, kktb = pallas_batched_barrier_qp_solve(
        _stack_qps(qps), dx0, num_iters=8, interpret=True
    )
    assert dXb.shape == (B, 9, 3) and dUb.shape == (B, 8, 2)
    for i in range(B):
        dX, dU, kkt = pallas_barrier_qp_solve(
            qps[i], dx0[i], num_iters=8, interpret=True
        )
        np.testing.assert_allclose(
            np.asarray(dXb[i]), np.asarray(dX), rtol=2e-5, atol=2e-5,
            err_msg=f"member {i}",
        )
        np.testing.assert_allclose(
            np.asarray(dUb[i]), np.asarray(dU), rtol=2e-5, atol=2e-5
        )
        np.testing.assert_allclose(
            float(kktb[i]), float(kkt), rtol=2e-4, atol=2e-6
        )


def test_batched_kernel_grid_beyond_lane_width():
    """B beyond one program's block spills into a grid of member blocks;
    padding members replicate the last member and are sliced off."""
    from dnn_mppi_mpc.ops.pallas.riccati_qp import (
        BLOCK_B,
        pallas_batched_barrier_qp_solve,
    )

    B = 130  # 5 member blocks of 32, 30 padded members
    assert B % BLOCK_B != 0 and B > 4 * BLOCK_B
    base = _random_qp(np.random.default_rng(0), N=4, nx=2, nu=1, n_h=0)
    rng = np.random.default_rng(1)
    # same structure, per-member gradients: cheap way to make B distinct QPs
    qxb = jnp.asarray(0.5 * rng.normal(size=(B,) + base.qx_base.shape), jnp.float32)
    qp_b = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), base
    )._replace(qx_base=qxb)
    dx0 = jnp.asarray(0.1 * rng.normal(size=(B, 2)), jnp.float32)

    dXb, dUb, _ = pallas_batched_barrier_qp_solve(
        qp_b, dx0, num_iters=4, interpret=True
    )
    for i in (0, 31, 32, 127, 128, 129):  # several blocks, incl. block edges
        qp_i = base._replace(qx_base=qxb[i])
        dX, dU, _ = pallas_barrier_qp_solve(
            qp_i, dx0[i], num_iters=4, interpret=True
        )
        np.testing.assert_allclose(
            np.asarray(dUb[i]), np.asarray(dU), rtol=2e-5, atol=2e-5,
            err_msg=f"member {i}",
        )
        np.testing.assert_allclose(
            np.asarray(dXb[i]), np.asarray(dX), rtol=2e-5, atol=2e-5
        )


def test_vmappable_wrapper_broadcasts_unbatched_args():
    """custom_vmap rule: leaves NOT carrying the vmapped axis (shared QP
    data, per-member dx0) are broadcast before the fleet dispatch."""
    from dnn_mppi_mpc.ops.pallas.riccati_qp import make_vmappable_pallas_qp

    qp = _random_qp(np.random.default_rng(5), N=6, nx=3, nu=2, n_h=2)
    B = 3
    rng = np.random.default_rng(6)
    dx0s = jnp.asarray(0.2 * rng.normal(size=(B, 3)), jnp.float32)

    solve = make_vmappable_pallas_qp(6, 1.0e-1, 0.35, None, 0.0, True)
    # qp unbatched (in_axes=None), dx0 batched
    dXb, dUb, kktb = jax.vmap(solve, in_axes=(None, 0))(qp, dx0s)
    for i in range(B):
        dX, dU, kkt = solve(qp, dx0s[i])
        np.testing.assert_allclose(
            np.asarray(dUb[i]), np.asarray(dU), rtol=2e-5, atol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(dXb[i]), np.asarray(dX), rtol=2e-5, atol=2e-5
        )
        np.testing.assert_allclose(float(kktb[i]), float(kkt), rtol=2e-4, atol=2e-6)


@pytest.mark.gpu
def test_batched_kernel_on_hardware(gpu, f32_mode):
    """Compiled fleet kernel vs the compiled single-problem solve on the
    card (N=30 diff-drive dims — the nmpc_fleet row's configuration)."""
    from dnn_mppi_mpc.ops.pallas.riccati_qp import (
        pallas_batched_barrier_qp_solve,
    )

    B = 16
    qps = [
        _random_qp(np.random.default_rng(20 + i), N=30, nx=3, nu=2,
                   n_h=2, with_S=True)
        for i in range(B)
    ]
    rng = np.random.default_rng(2)
    dx0 = jnp.asarray(0.2 * rng.normal(size=(B, 3)), jnp.float32)
    dXb, dUb, kktb = jax.block_until_ready(
        pallas_batched_barrier_qp_solve(_stack_qps(qps), dx0, num_iters=12)
    )
    assert np.all(np.isfinite(np.asarray(dXb)))
    for i in range(0, B, 5):
        dX, dU, _ = pallas_barrier_qp_solve(qps[i], dx0[i], num_iters=12)
        np.testing.assert_allclose(
            np.asarray(dUb[i]), np.asarray(dU), rtol=1e-4, atol=1e-4,
            err_msg=f"member {i}",
        )


def test_batched_solve_differentiable_escape_hatch():
    """jax.grad through a pallas-backend fleet: the kernels have no
    autodiff rule, so batched_solve(differentiable=True) must route to the
    (semantically identical) XLA Riccati backend and differentiate."""
    from dnn_mppi_mpc.config import SQPConfig
    from dnn_mppi_mpc.models.dynamics import unicycle
    from dnn_mppi_mpc.solvers.sqp import NMPCSolver, NMPCState, OCPParams

    cfg = SQPConfig(
        N=5, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=4,
        qp_backend="pallas",
    )
    solver = NMPCSolver(cfg, unicycle)
    goal = jnp.array([1.0, 0.5, 0.0], jnp.float32)
    op = OCPParams(
        Q=jnp.eye(3), R=jnp.eye(2) * 0.1, Qe=jnp.eye(3),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(5, axis=0),
        yref_e=goal,
        lbx=jnp.full(3, -10.0), ubx=jnp.full(3, 10.0),
        # loose bounds: a saturated u0 has ~zero sensitivity to x0, which
        # would make the nonzero-gradient assertion vacuous
        lbu=jnp.full(2, -5.0), ubu=jnp.full(2, 5.0),
    )
    B = 2
    bop = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape) if a is not None else None,
        op,
    )
    fleet = solver.batched_solve(differentiable=True)

    def loss(x0s):
        bst = jax.vmap(lambda x: NMPCState.init(cfg, x))(x0s)
        u0s, _, _ = fleet(bop, bst, x0s)
        return jnp.sum(u0s**2)

    g = jax.grad(loss)(jnp.asarray([[0.2, -0.1, 0.0], [-0.3, 0.2, 0.1]], jnp.float32))
    assert g.shape == (B, 3)
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.max(jnp.abs(g))) > 0.0


@pytest.mark.slow
def test_batched_kernel_fuzz_dims():
    """Randomized dims fuzz for the fleet kernel: per-member parity with the
    single-problem solve across (nx, nu, n_h, S, N, B) combinations."""
    from dnn_mppi_mpc.ops.pallas.riccati_qp import (
        pallas_batched_barrier_qp_solve,
    )

    for seed in range(4):
        rng = np.random.default_rng(200 + seed)
        N = int(rng.integers(3, 9))
        nx = int(rng.integers(2, 5))
        nu = int(rng.integers(1, min(nx, 3) + 1))
        n_h = int(rng.integers(0, 3))
        with_S = bool(rng.integers(0, 2))
        B = int(rng.integers(2, 7))
        qps = [
            _random_qp(np.random.default_rng(1000 * seed + i), N=N, nx=nx,
                       nu=nu, n_h=n_h, with_S=with_S)
            for i in range(B)
        ]
        dx0 = jnp.asarray(0.15 * rng.normal(size=(B, nx)), jnp.float32)
        dXb, dUb, _ = pallas_batched_barrier_qp_solve(
            _stack_qps(qps), dx0, num_iters=5, interpret=True
        )
        for i in range(B):
            dX, dU, _ = pallas_barrier_qp_solve(
                qps[i], dx0[i], num_iters=5, interpret=True
            )
            np.testing.assert_allclose(
                np.asarray(dUb[i]), np.asarray(dU), rtol=3e-5, atol=3e-5,
                err_msg=f"seed {seed} member {i} dims N={N} nx={nx} nu={nu} "
                        f"n_h={n_h} S={with_S}",
            )
            np.testing.assert_allclose(
                np.asarray(dXb[i]), np.asarray(dX), rtol=3e-5, atol=3e-5
            )


@pytest.mark.parametrize(
    "n_h,with_S", [(0, False), (2, False), (0, True), (2, True)]
)
def test_kernel_follows_f64_problems(n_h, with_S):
    """An f64 problem runs the kernel in f64 (the oracle-parity mode on the
    card): the fleet kernel then matches the XLA solve to f64 rounding."""
    from dnn_mppi_mpc.ops.pallas.riccati_qp import pallas_batched_barrier_qp_solve

    B = 3
    qps = [
        jax.tree.map(
            lambda a: a.astype(jnp.float64),
            _random_qp(np.random.default_rng(40 + i), N=8, n_h=n_h, with_S=with_S),
        )
        for i in range(B)
    ]
    dx0 = jnp.asarray(0.2 * np.random.default_rng(4).normal(size=(B, 3)), jnp.float64)
    dXb, dUb, kktb = pallas_batched_barrier_qp_solve(
        _stack_qps(qps), dx0, num_iters=8, interpret=True
    )
    assert dXb.dtype == jnp.float64
    for i in range(B):
        dX, dU, kkt = barrier_qp_solve(qps[i], dx0[i], num_iters=8, return_kkt=True)
        np.testing.assert_allclose(np.asarray(dUb[i]), np.asarray(dU), rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(np.asarray(dXb[i]), np.asarray(dX), rtol=1e-9, atol=1e-10)
