"""NMPC engine tests (the acados replacement, BASELINE config 4 path).

Closed-loop behavior mirrors the reference demos: diff-drive point
stabilization with obstacles (mpc_differential_drive_obstacle_static.py:376-521),
bounds respected, obstacles cleared, and the learned-residual variant
(mpc_mlp_differential_drive.py run()) solving through a Flax MLP in-graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.models.dynamics import (
    four_wheel_torque,
    kinematic_bicycle,
    residual_dynamics,
    unicycle,
    BicycleParams,
)
from dnn_mppi_mpc.models.integrators import erk_step
from dnn_mppi_mpc.models.learned import MLP, make_residual_fn
from dnn_mppi_mpc.solvers.sqp import (
    NMPCSolver,
    NMPCState,
    OCPParams,
    circle_obstacle_h,
)


def _diff_drive_params(N, with_obstacles=False, goal=None):
    """Weights/bounds from the reference main
    (mpc_differential_drive_obstacle_static.py:383-410 ballpark)."""
    Q = jnp.diag(jnp.array([10.0, 10.0, 0.1]))
    R = jnp.diag(jnp.array([0.5, 0.05]))
    Qe = jnp.diag(jnp.array([10.0, 10.0, 0.1]))
    goal = jnp.array([3.0, 2.0, 0.0]) if goal is None else goal
    yref = jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0)
    p = (
        jnp.array([[1.5, 1.0, 0.45]])  # (ox, oy, r+safe) on the straight-line path
        if with_obstacles
        else None
    )
    return OCPParams(
        Q=Q,
        R=R,
        Qe=Qe,
        yref=yref,
        yref_e=goal,
        lbx=jnp.array([-10.0, -10.0, -10.0]),
        ubx=jnp.array([10.0, 10.0, 10.0]),
        lbu=jnp.array([-1.0, -1.0]),
        ubu=jnp.array([1.0, 1.0]),
        p=p,
    )


def test_nmpc_point_stabilization():
    N, dt = 20, 0.1
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, unicycle)
    params = _diff_drive_params(N)
    x = jnp.array([0.0, 0.0, 0.0])
    state = solver.init(x)
    for _ in range(80):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(unicycle, x, u0, dt, num_steps=3)
    err = float(jnp.linalg.norm(x[:2] - jnp.array([3.0, 2.0])))
    assert err < 0.05, f"did not stabilize: final pos error {err:.3f}"


def test_nmpc_respects_control_bounds():
    N, dt = 20, 0.1
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=12)
    solver = NMPCSolver(cfg, unicycle)
    params = _diff_drive_params(N)
    x = jnp.array([0.0, 0.0, 0.0])
    state = solver.init(x)
    for _ in range(30):
        u0, state, aux = solver.solve(params, state, x)
        assert float(jnp.max(jnp.abs(u0))) <= 1.0 + 1e-2, u0
        assert float(jnp.max(jnp.abs(aux.U))) <= 1.0 + 1e-2
        x = erk_step(unicycle, x, u0, dt, num_steps=3)


def test_nmpc_avoids_obstacle():
    N, dt = 25, 0.1
    cfg = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=14, n_h_constraints=1
    )
    solver = NMPCSolver(cfg, unicycle, h_fn=circle_obstacle_h)
    params = _diff_drive_params(N, with_obstacles=True)
    x = jnp.array([0.0, 0.0, 0.0])
    state = solver.init(x)
    min_clearance = np.inf
    for _ in range(100):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(unicycle, x, u0, dt, num_steps=3)
        d = float(jnp.linalg.norm(x[:2] - jnp.array([1.5, 1.0])))
        min_clearance = min(min_clearance, d)
    err = float(jnp.linalg.norm(x[:2] - jnp.array([3.0, 2.0])))
    assert err < 0.1, f"did not reach goal: {err:.3f}"
    # obstacle radius+safe = 0.45; allow small barrier slack
    assert min_clearance > 0.40, f"drove through obstacle: clearance {min_clearance:.3f}"


def test_nmpc_sqp_converges_to_kinematic_feasibility():
    """Multiple-shooting defect must be ~0 after convergence (the role of
    acados' ERK equality constraints)."""
    N, dt = 15, 0.1
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=4, qp_iters=10)
    solver = NMPCSolver(cfg, unicycle)
    params = _diff_drive_params(N)
    x = jnp.array([0.0, 0.0, 0.0])
    state = solver.init(x)
    for _ in range(5):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(unicycle, x, u0, dt, num_steps=3)
    assert float(aux.defect) < 2e-3, f"shooting defect {float(aux.defect):.2e}"


def test_nmpc_racecar_bicycle():
    """Kinematic bicycle NMPC (mpc_racecar.py recipe, L=0.325)."""
    N, dt = 30, 0.05
    cfg = SQPConfig(N=N, dim_x=4, dim_u=2, dt=dt, sqp_iters=2, qp_iters=10)
    bp = BicycleParams(wheel_base=jnp.asarray(0.325))
    dyn = lambda x, u: kinematic_bicycle(x, u, bp)
    solver = NMPCSolver(cfg, dyn)
    goal = jnp.array([2.0, 1.0, 0.0, 0.0])
    params = OCPParams(
        Q=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        R=jnp.diag(jnp.array([0.5, 0.5])),
        Qe=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.array([-10.0, -10.0, -10.0, -3.0]),
        ubx=jnp.array([10.0, 10.0, 10.0, 3.0]),
        lbu=jnp.array([-0.4, -2.0]),
        ubu=jnp.array([0.4, 2.0]),
    )
    x = jnp.array([0.0, 0.0, 0.0, 0.0])
    state = solver.init(x)
    for _ in range(120):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(dyn, x, u0, dt, num_steps=3)
    err = float(jnp.linalg.norm(x[:2] - goal[:2]))
    assert err < 0.15, f"racecar did not reach goal: {err:.3f}"


def test_nmpc_four_wheel_torque():
    """Four-wheel torque-input NMPC (mpc_differential_dynamics.py model)."""
    N, dt = 20, 0.1
    cfg = SQPConfig(N=N, dim_x=5, dim_u=4, dt=dt, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, four_wheel_torque)
    goal = jnp.array([1.0, 0.5, 0.0, 0.0, 0.0])
    params = OCPParams(
        Q=jnp.diag(jnp.array([20.0, 20.0, 1.0, 1.0, 1.0])),
        R=jnp.eye(4) * 0.1,
        Qe=jnp.diag(jnp.array([20.0, 20.0, 1.0, 1.0, 1.0])),
        yref=jnp.concatenate([goal, jnp.zeros(4)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.full((5,), -20.0),
        ubx=jnp.full((5,), 20.0),
        lbu=jnp.full((4,), -5.0),
        ubu=jnp.full((4,), 5.0),
    )
    x = jnp.zeros(5)
    state = solver.init(x)
    for _ in range(80):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(four_wheel_torque, x, u0, dt, num_steps=3)
    err = float(jnp.linalg.norm(x[:2] - goal[:2]))
    assert err < 0.1, f"four-wheel NMPC error {err:.3f}"


def test_nmpc_learned_residual_dynamics():
    """DNN-NMPC: SQP through analytic + Flax-MLP residual dynamics — the
    l4casadi replacement exercised end-to-end (BASELINE config 4)."""
    N, dt = 15, 0.1
    model = MLP(out_dim=3, hidden=64, depth=2, zero_init_head=False)
    mparams = model.init(jax.random.PRNGKey(0), jnp.ones((1, 5)))
    # scale the net down so it's a mild residual
    mparams = jax.tree.map(lambda a: a * 0.05, mparams)
    net = make_residual_fn(model, mparams)
    dyn = residual_dynamics(unicycle, net)

    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, dyn)
    # nearer goal + fewer ticks than the original (3, 2)/80: each tick is an
    # f64 CPU jacfwd through the MLP (~0.24 s) and convergence is decided in
    # the first ~20 (verdict r3 #9 suite-time work)
    goal = jnp.array([1.2, 0.8, 0.0])
    params = _diff_drive_params(N, goal=goal)
    x = jnp.array([0.0, 0.0, 0.0])
    state = solver.init(x)
    for _ in range(32):
        u0, state, aux = solver.solve(params, state, x)
        # plant = the same perturbed dynamics (model-matched case)
        x = erk_step(dyn, x, u0, dt, num_steps=3)
    err = float(jnp.linalg.norm(x[:2] - goal[:2]))
    assert err < 0.1, f"DNN-NMPC error {err:.3f}"


def test_batched_nmpc_fleet_matches_single():
    """vmapped fleet solve equals per-problem solves (batched Riccati axis)."""
    N, dt = 12, 0.1
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, unicycle)
    B = 4
    goals = jnp.asarray(
        [[2.0, 1.0, 0.0], [1.0, -1.0, 0.0], [-1.5, 0.5, 0.0], [0.5, 2.0, 0.0]]
    )
    x0s = jnp.asarray(np.random.default_rng(0).uniform(-0.3, 0.3, (B, 3)))

    def make_params(goal):
        return OCPParams(
            Q=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
            R=jnp.diag(jnp.array([0.5, 0.05])),
            Qe=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
            yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
            yref_e=goal,
            lbx=jnp.full(3, -10.0),
            ubx=jnp.full(3, 10.0),
            lbu=jnp.array([-1.0, -1.0]),
            ubu=jnp.array([1.0, 1.0]),
        )

    batched_params = jax.vmap(make_params)(goals)
    batched_states = jax.vmap(lambda x: NMPCState.init(cfg, x))(x0s)
    fleet = solver.batched_solve()
    u0s, new_states, auxs = fleet(batched_params, batched_states, x0s)
    assert u0s.shape == (B, 2)

    for b in range(B):
        u0, _, _ = solver.solve(
            make_params(goals[b]), NMPCState.init(cfg, x0s[b]), x0s[b]
        )
        np.testing.assert_allclose(np.asarray(u0s[b]), np.asarray(u0), rtol=1e-4, atol=1e-5)


def test_batched_fleet_works_with_pallas_qp_backend():
    """A qp_backend="pallas" solver must still serve fleets: under vmap the
    custom_vmap rule dispatches the fleet QP kernel (one member per thread,
    ops/pallas/riccati_qp.py) with identical per-member results."""
    N, dt = 10, 0.1
    cfg = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=1, qp_iters=8,
        qp_backend="pallas",
    )
    solver = NMPCSolver(cfg, unicycle, interpret=True)
    B = 3
    goals = jnp.asarray([[2.0, 1.0, 0.0], [1.0, -1.0, 0.0], [-1.5, 0.5, 0.0]])
    x0s = jnp.asarray(
        np.random.default_rng(1).uniform(-0.3, 0.3, (B, 3)), jnp.float32
    )

    def make_params(goal):
        return OCPParams(
            Q=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
            R=jnp.diag(jnp.array([0.5, 0.05])),
            Qe=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
            yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
            yref_e=goal,
            lbx=jnp.full(3, -10.0),
            ubx=jnp.full(3, 10.0),
            lbu=jnp.array([-1.0, -1.0]),
            ubu=jnp.array([1.0, 1.0]),
        )

    fleet = solver.batched_solve()
    u0s, _, _ = fleet(
        jax.vmap(make_params)(goals),
        jax.vmap(lambda x: NMPCState.init(cfg, x))(x0s),
        x0s,
    )
    assert u0s.shape == (B, 2)
    for b in range(B):
        u0, _, _ = solver.solve(
            make_params(goals[b]), NMPCState.init(cfg, x0s[b]), x0s[b]
        )
        np.testing.assert_allclose(
            np.asarray(u0s[b]), np.asarray(u0), rtol=1e-4, atol=1e-5
        )


def test_soft_h_constraints_trade_violation_for_tracking():
    """Soft (slack) h-constraints — the Zl/zl slack formulation of
    test_diff_mpc_dyna_slack.py:158-182: when the goal itself violates the
    constraint (infeasible set), the hard-barrier solver parks at the boundary
    while the soft solver trades a bounded violation for tracking."""
    N, dt = 20, 0.1
    goal = jnp.array([3.0, 2.0, 0.0])
    # obstacle centered ON the goal: reaching the goal necessarily violates h
    p = jnp.array([[3.0, 2.0, 0.8]])
    params = OCPParams(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        R=jnp.diag(jnp.array([0.5, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.full(3, -10.0),
        ubx=jnp.full(3, 10.0),
        lbu=jnp.array([-1.0, -1.0]),
        ubu=jnp.array([1.0, 1.0]),
        p=p,
    )

    def run(cfg):
        solver = NMPCSolver(cfg, unicycle, h_fn=circle_obstacle_h)
        x = jnp.array([0.0, 0.0, 0.0])
        state = solver.init(x)
        for _ in range(80):
            u0, state, aux = solver.solve(params, state, x)
            x = erk_step(unicycle, x, u0, dt, num_steps=3)
        return float(jnp.linalg.norm(x[:2] - goal[:2]))

    cfg_hard = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=12)
    cfg_soft = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=12,
        soft_h=True, slack_weight_l2=1.0, slack_weight_l1=0.1,
    )
    err_hard = run(cfg_hard)
    err_soft = run(cfg_soft)
    # hard solver stops near the 0.8 ring; soft one penetrates toward the goal
    assert err_hard > 0.6, err_hard
    assert err_soft < err_hard - 0.2, (err_soft, err_hard)


@pytest.mark.slow
def test_nmpc_racecar_learned_residual():
    """Race-car NMPC over bicycle + MLP residual (mpc_racecar_dnn.py:40-96):
    the learned-dynamics path on the 4-state bicycle."""
    N, dt = 20, 0.05
    model = MLP(out_dim=4, hidden=32, depth=2, zero_init_head=False)
    mp = model.init(jax.random.PRNGKey(2), jnp.ones((1, 6)))
    mp = jax.tree.map(lambda a: a * 0.05, mp)
    net = make_residual_fn(model, mp)
    bp = BicycleParams(wheel_base=jnp.asarray(0.325))
    dyn = residual_dynamics(lambda x, u: kinematic_bicycle(x, u, bp), net)

    cfg = SQPConfig(N=N, dim_x=4, dim_u=2, dt=dt, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, dyn)
    goal = jnp.array([1.5, 0.8, 0.0, 0.0])
    params = OCPParams(
        Q=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        R=jnp.diag(jnp.array([0.5, 0.5])),
        Qe=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.array([-10.0, -10.0, -10.0, -3.0]),
        ubx=jnp.array([10.0, 10.0, 10.0, 3.0]),
        lbu=jnp.array([-0.4, -2.0]),
        ubu=jnp.array([0.4, 2.0]),
    )
    x = jnp.array([0.0, 0.0, 0.0, 0.0])
    state = solver.init(x)
    for _ in range(120):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(dyn, x, u0, dt, num_steps=3)
    err = float(jnp.linalg.norm(x[:2] - goal[:2]))
    assert err < 0.2, f"racecar DNN-NMPC error {err:.3f}"


def test_nmpc_nonlinear_ls_cost():
    """NONLINEAR_LS residual cost (acados cost_y_expr, separable form):
    track a target in a nonlinear output space — here polar coordinates
    y(x) = (r, θ, yaw) — and still converge to the Cartesian goal."""
    N, dt = 15, 0.1
    goal_xy = np.array([2.0, 1.5])
    goal_pol = jnp.array(
        [np.hypot(*goal_xy), np.arctan2(goal_xy[1], goal_xy[0]), 0.0]
    )

    def y_x(x):
        r = jnp.sqrt(x[0] ** 2 + x[1] ** 2 + 1e-6)
        th = jnp.arctan2(x[1], x[0] + 1e-6)
        return jnp.stack([r, th, x[2]])

    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, unicycle, y_x_fn=y_x)
    params = OCPParams(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.2])),  # weights in y-space (r, θ, yaw)
        R=jnp.diag(jnp.array([0.2, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.2])),
        yref=jnp.concatenate([goal_pol, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal_pol,
        lbx=jnp.full(3, -20.0),
        ubx=jnp.full(3, 20.0),
        lbu=jnp.array([-1.5, -1.5]),
        ubu=jnp.array([1.5, 1.5]),
    )
    x = jnp.array([0.3, 0.05, 0.0])  # off origin so polar coords are defined
    state = solver.init(x)
    for _ in range(100):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(unicycle, x, u0, dt, num_steps=3)
    err = float(jnp.linalg.norm(np.asarray(x[:2]) - goal_xy))
    # The polar OCP has a FLAT valley of local optima near the goal: from the
    # converged point, scipy SLSQP on the dense NLP returns u=0 as optimal
    # (cost identical to 10 digits) at Cartesian offset ~0.20 — the loop is
    # at a genuine OCP equilibrium, not failing to converge. The bound below
    # covers the whole valley; which equilibrium is reached depends on the
    # merit/damping transient (changed when the l1 merit gained the
    # initial-condition residual in round 2).
    assert err < 0.25, f"NONLINEAR_LS NMPC error {err:.3f}"


def test_nmpc_racecar_avoids_obstacle():
    """Race-car NMPC with obstacle h-constraints — the
    mpc_racecar_obstacle_static.py configuration (#13) exercised directly:
    kinematic bicycle + circle_obstacle_h, goal behind the obstacle."""
    N, dt = 30, 0.05
    cfg = SQPConfig(
        N=N, dim_x=4, dim_u=2, dt=dt, sqp_iters=2, qp_iters=14, n_h_constraints=1
    )
    bp = BicycleParams(wheel_base=jnp.asarray(0.325))
    dyn = lambda x, u: kinematic_bicycle(x, u, bp)
    solver = NMPCSolver(cfg, dyn, h_fn=circle_obstacle_h)
    goal = jnp.array([2.0, 1.0, 0.0, 0.0])
    obstacle = jnp.array([[1.0, 0.5, 0.35]])  # (ox, oy, r+safe) on the path
    params = OCPParams(
        Q=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        R=jnp.diag(jnp.array([0.5, 0.5])),
        Qe=jnp.diag(jnp.array([20.0, 20.0, 0.5, 1.0])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.array([-10.0, -10.0, -10.0, -3.0]),
        ubx=jnp.array([10.0, 10.0, 10.0, 3.0]),
        lbu=jnp.array([-0.4, -2.0]),
        ubu=jnp.array([0.4, 2.0]),
        p=obstacle,
    )
    x = jnp.array([0.0, 0.0, 0.0, 0.0])
    state = solver.init(x)
    min_clearance = np.inf
    for _ in range(140):
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(dyn, x, u0, dt, num_steps=3)
        d = float(jnp.linalg.norm(x[:2] - obstacle[0, :2]))
        min_clearance = min(min_clearance, d)
    err = float(jnp.linalg.norm(x[:2] - goal[:2]))
    assert err < 0.15, f"racecar did not reach goal: {err:.3f}"
    assert min_clearance > 0.30, f"clearance {min_clearance:.3f}"


def test_nmpc_moving_obstacle_per_tick_params():
    """Dynamic-obstacle NMPC (#10, mpc_differential_drive_obstacle_dynamic.py):
    the obstacle's position advances every control frame (:467-471) and is
    passed through params.p without retracing; the controller must stay clear
    of the *moving* disc and still reach the goal."""
    N, dt = 25, 0.1
    cfg = SQPConfig(
        N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=14, n_h_constraints=1
    )
    solver = NMPCSolver(cfg, unicycle, h_fn=circle_obstacle_h)
    base = _diff_drive_params(N, with_obstacles=True)
    x = jnp.array([0.0, 0.0, 0.0])
    state = solver.init(x)
    # obstacle drifts across the straight-line path (crosses y≈1 around the
    # time the robot passes) — per-frame updates, as in the reference
    pos0 = np.array([1.5, 0.2])
    vel = np.array([0.0, 0.25])
    min_clearance = np.inf
    import dataclasses

    for k in range(100):
        pos = pos0 + vel * (k * dt)
        params = dataclasses.replace(
            base, p=jnp.asarray([[pos[0], pos[1], 0.45]], jnp.float32)
        )
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(unicycle, x, u0, dt, num_steps=3)
        pos_next = pos0 + vel * ((k + 1) * dt)
        d = float(jnp.linalg.norm(x[:2] - jnp.asarray(pos_next)))
        min_clearance = min(min_clearance, d)
    err = float(jnp.linalg.norm(x[:2] - jnp.array([3.0, 2.0])))
    assert err < 0.1, f"did not reach goal: {err:.3f}"
    assert min_clearance > 0.40, f"hit moving obstacle: {min_clearance:.3f}"
