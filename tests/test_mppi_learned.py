"""DNN-MPPI: sampling-based MPPI over learned-residual dynamics.

The reference pairs its DNN residual models with acados NMPC
(simulation/bullet_differential_drive_dnn.py) and collects the training data
*with* a batched MPPI controller (train/bullet_mppi_differential_drive.py:
222-283, MPPIWrapper K=50/T=5 driving the Husky) — but never closes the loop
MPPI-over-the-learned-model. Here the same residual pipeline plugs straight
into the MPPI engine (dynamics_step is an arbitrary function; the K-batched
MLP calls are plain (K, feat) matmuls), completing the DNN-MPPI corner of the
framework: collect with MPPI → train residual → control with MPPI over the
corrected model.
"""

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc.envs.closed_loop import (
    collect_residual_dataset,
    mppi_controller,
    run_closed_loop,
)
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import euler_step
from dnn_mppi_mpc.models.learned import MLP, make_residual_fn
from dnn_mppi_mpc.paths import line
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.train.training import TrainConfig, train_residual_model

DT = 0.05


def _nominal_step(x, u):
    return euler_step(unicycle, x, u, DT)


def _plant_step(x, u):
    """The 'real' robot: systematic actuation error the nominal model misses —
    wheel slip (velocity gain 0.72) and a speed-coupled yaw-rate error (the
    kind of discrepancy the reference's Husky data exhibits,
    train/bullet_mpc_differential_drive.py:96 error = state − nominal)."""
    u_eff = jnp.stack([0.72 * u[..., 0], 0.88 * u[..., 1] + 0.18 * u[..., 0]], -1)
    return euler_step(unicycle, x, u_eff, DT)


def _make_solver(dynamics_step, K=256, horizon=15):
    cfg = MPPIConfig(
        num_samples=K, horizon=horizon, dim_x=3, dim_u=2, dt=DT,
        lam=1.0, alpha=0.2, exploration=0.0001, waypoint_search_len=20,
    )
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.0], [0.0, 0.1]], jnp.float32),
        stage_weight=jnp.array([8.0, 8.0, 2.0], jnp.float32),
        terminal_weight=jnp.array([8.0, 8.0, 2.0], jnp.float32),
        u_min=jnp.array([-3.0, -3.14], jnp.float32),
        u_max=jnp.array([3.0, 3.14], jnp.float32),
        ref_path=line(jnp.zeros(2), jnp.array([4.0, 2.0]), num_points=120),
    )
    solver = MPPISolver(cfg, dynamics_step, *make_tracking_costs(cfg))
    return solver, params


def _tracking_rmse(dynamics_step, ticks=100):
    solver, params = _make_solver(dynamics_step)
    episode, _ = run_closed_loop(
        mppi_controller(solver, params), _plant_step, solver.init(),
        jnp.array([0.0, 0.6, 0.0], jnp.float32), ticks,
    )
    xy = np.asarray(episode.states[:, :2], np.float64)
    path = np.asarray(params.ref_path[:, :2], np.float64)
    d = np.linalg.norm(xy[:, None, :] - path[None, :, :], axis=-1).min(axis=1)
    return float(np.sqrt(np.mean(d[ticks // 2:] ** 2)))  # steady-state half


def test_dnn_mppi_closes_model_error():
    """MPPI-collected data → residual MLP → MPPI over the corrected model.

    The corrected model must predict the real plant far better than the
    nominal one on the distribution the controller actually visits, and the
    closed loop over the corrected model must not regress (feedback already
    masks much of this plant's actuation error at 20 Hz, so equality — not
    dramatic improvement — is the honest closed-loop expectation; the
    reference's DNN-NMPC claims rest on the same residual-fit evidence,
    train/train_diff_mlp.py loss curves)."""
    # 1. collect (states, controls, errors) with MPPI driving the real plant
    def factory(key):
        solver, params = _make_solver(_nominal_step, K=128, horizon=10)
        return mppi_controller(solver, params), solver.init()

    def x0_sampler(key):
        return jax.random.uniform(
            key, (3,), jnp.float32,
            jnp.array([-0.5, -0.5, -0.6]), jnp.array([0.5, 0.5, 0.6]),
        )

    data = collect_residual_dataset(
        factory, _plant_step, _nominal_step, x0_sampler,
        jax.random.PRNGKey(0), num_series=8, ticks_per_series=60,
    )
    assert data.states.shape[0] == 8 * 60

    # 2. train the residual MLP (train/train_diff_mlp.py loop, in-graph scalers)
    model = MLP(out_dim=3, hidden=64, depth=2)
    tstate, hist = train_residual_model(
        model, data.states, data.controls, data.errors,
        TrainConfig(num_epochs=80, batch_size=128, learning_rate=2e-3),
    )
    assert hist["val_mse"][-1] < 0.2, hist["val_mse"][-5:]

    # 3. corrected discrete model: nominal + learned residual on (x, u)
    net = make_residual_fn(model, tstate.params, tstate.in_scaler, tstate.out_scaler)

    def corrected_step(x, u):
        return _nominal_step(x, u) + net(jnp.concatenate([x, u], axis=-1))

    # On the visited distribution the residual net must absorb most of the
    # nominal model's one-step error (data.errors IS that error, by
    # construction of collect_residual_dataset).
    feats = jnp.concatenate([data.states, data.controls], axis=-1)
    resid_after = np.asarray(data.errors - net(feats), np.float64)
    resid_before = np.asarray(data.errors, np.float64)
    rms = lambda a: float(np.sqrt(np.mean(a**2)))
    assert rms(resid_after) < 0.35 * rms(resid_before), (
        rms(resid_after), rms(resid_before),
    )

    # Closed loop over the corrected model: no regression vs the nominal
    # model, and absolute tracking stays sane.
    rmse_nominal = _tracking_rmse(_nominal_step)
    rmse_dnn = _tracking_rmse(corrected_step)
    assert rmse_dnn < 1.15 * rmse_nominal, (rmse_dnn, rmse_nominal)
    assert rmse_dnn < 0.5, rmse_dnn


def test_mppi_over_learned_model_runs_and_is_finite():
    """Pure-DNN dynamics (no analytic part) through the MPPI engine: the
    K-batched MLP rollout path is shape-correct and numerically sane."""
    model = MLP(out_dim=3, hidden=32, depth=1)
    params_net = model.init(jax.random.PRNGKey(1), jnp.ones((1, 5)))
    net = make_residual_fn(model, params_net)

    def dnn_step(x, u):
        # zero-init head → residual 0 at init; add identity so the model is
        # a sane discrete map even untrained
        return x + net(jnp.concatenate([x, u], axis=-1))

    solver, params = _make_solver(dnn_step, K=64, horizon=8)
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3, jnp.float32))
    assert u0.shape == (2,)
    assert bool(jnp.all(jnp.isfinite(aux.costs)))
    assert int(aux.status) == 0
