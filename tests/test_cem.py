"""CEM solver tests (the optimizer the reference stubbed,
mppi_differential_drive.py:251-252)."""

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import euler_step
from dnn_mppi_mpc.solvers.cem import CEMConfig, CEMSolver
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.paths.generators import line

DT = 0.1


def _problem():
    mcfg = MPPIConfig(num_samples=256, horizon=15, dim_x=3, dim_u=2, dt=DT)
    params = MPPIParams(
        sigma=jnp.array([[0.1, 0.0], [0.0, 0.05]]),
        stage_weight=jnp.array([5.0, 5.0, 2.0]),
        terminal_weight=jnp.array([5.0, 5.0, 2.0]),
        u_min=jnp.array([-2.0, -2.0]),
        u_max=jnp.array([2.0, 2.0]),
        ref_path=line(jnp.zeros(2), jnp.array([6.0, 0.0]), 80),
    )
    step = lambda x, u: euler_step(unicycle, x, u, DT)
    stage, terminal = make_tracking_costs(mcfg)
    return mcfg, params, step, stage, terminal


def test_cem_iterations_reduce_cost():
    mcfg, params, step, stage, terminal = _problem()
    ccfg = CEMConfig(num_samples=256, horizon=15, dim_x=3, dim_u=2, dt=DT, num_iters=6)
    solver = CEMSolver(ccfg, step, stage, terminal)
    u0, st, aux = solver.step(params, solver.init(jax.random.PRNGKey(0)), jnp.zeros(3))
    assert np.isfinite(float(aux.best_cost))
    # within one tick, elite cost after all iterations should beat a fresh
    # random shot: run a second solver with a single iteration to compare
    ccfg1 = CEMConfig(num_samples=256, horizon=15, dim_x=3, dim_u=2, dt=DT, num_iters=1)
    s1 = CEMSolver(ccfg1, step, stage, terminal)
    _, _, aux1 = s1.step(params, s1.init(jax.random.PRNGKey(0)), jnp.zeros(3))
    assert float(aux.best_cost) < float(aux1.best_cost)


def test_cem_closed_loop_tracks_line():
    mcfg, params, step, stage, terminal = _problem()
    ccfg = CEMConfig(num_samples=256, horizon=15, dim_x=3, dim_u=2, dt=DT, num_iters=4)
    solver = CEMSolver(ccfg, step, stage, terminal)
    x = jnp.zeros(3)
    st = solver.init(jax.random.PRNGKey(1))
    for _ in range(80):
        u0, st, aux = solver.step(params, st, x)
        x = step(x, u0)
    assert float(x[0]) > 0.5, f"no progress: {np.asarray(x)}"
    assert abs(float(x[1])) < 0.5, f"off path: {np.asarray(x)}"
    assert np.all(np.isfinite(np.asarray(x)))


def test_cem_comparable_to_mppi():
    """Same problem, same budget: CEM tracking should be in the same league as
    MPPI (sanity, not superiority)."""
    mcfg, params, step, stage, terminal = _problem()
    mppi = MPPISolver(mcfg, step, stage, terminal)
    ccfg = CEMConfig(num_samples=256, horizon=15, dim_x=3, dim_u=2, dt=DT, num_iters=3)
    cem = CEMSolver(ccfg, step, stage, terminal)

    def run(stepper, st):
        x = jnp.zeros(3)
        for _ in range(60):
            u0, st, _ = stepper(params, st, x)
            x = step(x, u0)
        return float(x[0])

    prog_mppi = run(lambda p, s, x: mppi.step(p, s, x), mppi.init(jax.random.PRNGKey(2)))
    prog_cem = run(lambda p, s, x: cem.step(p, s, x), cem.init(jax.random.PRNGKey(2)))
    assert prog_cem > 0.3 * max(prog_mppi, 0.3), (prog_cem, prog_mppi)
