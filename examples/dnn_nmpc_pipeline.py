"""Flagship DNN-NMPC pipeline: collect → train → deploy (reference §3.5).

Headless re-creation of the train/bullet_mpc_differential_drive.py →
train/train_diff_mlp.py → simulation/bullet_differential_drive_dnn.py chain:
a plant with systematic model error is excited with randomized controls, the
residual is regressed with a Flax MLP (in-graph scalers), and the resulting
residual-dynamics NMPC is compared against the nominal-model NMPC.

    python examples/dnn_nmpc_pipeline.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.envs.closed_loop import collect_residual_dataset
from dnn_mppi_mpc.models import erk_step, residual_dynamics, unicycle
from dnn_mppi_mpc.models.learned import MLP, make_residual_fn
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, OCPParams
from dnn_mppi_mpc.train.checkpoint import save_checkpoint
from dnn_mppi_mpc.train.training import TrainConfig, train_residual_model
from dnn_mppi_mpc.utils.plotting import plot_training_curves, plot_trajectory

DT = 0.1
N = 10


def true_dynamics(x, u):
    """The 'real robot' the nominal unicycle model gets wrong."""
    v_eff = 0.8 * u[..., 0]
    w_eff = 0.9 * u[..., 1] + 0.08 * u[..., 0]
    yaw = x[..., 2]
    return jnp.stack([v_eff * jnp.cos(yaw), v_eff * jnp.sin(yaw), w_eff], axis=-1)


def closed_loop(dyn_for_controller, goal, ticks=80):
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=DT, sqp_iters=2, qp_iters=10)
    solver = NMPCSolver(cfg, dyn_for_controller)
    params = OCPParams(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.5])),
        R=jnp.diag(jnp.array([0.2, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.5])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.full(3, -20.0),
        ubx=jnp.full(3, 20.0),
        lbu=jnp.array([-2.0, -2.0]),
        ubu=jnp.array([2.0, 2.0]),
    )
    plant = lambda x, u: erk_step(true_dynamics, x, u, DT, num_steps=3)
    x, state = jnp.zeros(3), solver.init(jnp.zeros(3))
    xs = [np.zeros(3)]
    for _ in range(ticks):
        u0, state, _ = solver.solve(params, state, x)
        x = plant(x, u0)
        xs.append(np.asarray(x))
    return np.asarray(xs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/dnn_nmpc")
    ap.add_argument("--series", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=80)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    # 1. collect (randomized excitation series, batched on-device)
    nominal_step = lambda x, u: erk_step(unicycle, x, u, DT, num_steps=3)
    plant_step = lambda x, u: erk_step(true_dynamics, x, u, DT, num_steps=3)

    def controller_factory(k):
        ks = jax.random.split(k, 3)
        amp = jax.random.uniform(ks[0], (2,), minval=0.3, maxval=1.5)
        freq = jax.random.uniform(ks[1], (2,), minval=0.2, maxval=1.0)
        phase = jax.random.uniform(ks[2], (2,), minval=0.0, maxval=6.28)

        def controller(t, x):
            return amp * jnp.sin(freq * t.astype(jnp.float32) + phase), t + 1

        return controller, jnp.int32(0)

    ep = collect_residual_dataset(
        controller_factory,
        plant_step,
        nominal_step,
        lambda k: jax.random.uniform(k, (3,), minval=-2.0, maxval=2.0),
        jax.random.PRNGKey(0),
        args.series,
        50,
    )
    ep = jax.tree.map(lambda a: a.astype(jnp.float32), ep)
    print(f"collected {ep.states.shape[0]} samples")

    # 2. train residual MLP (reference MLP shape: 5 → 512×2 → 3)
    model = MLP(out_dim=3, hidden=128, depth=2)
    tstate, hist = train_residual_model(
        model,
        ep.states,
        ep.controls,
        ep.errors / DT,
        TrainConfig(num_epochs=args.epochs, batch_size=256, learning_rate=2e-3),
    )
    print(f"train mse {hist['train_mse'][-1]:.5f}  val mse {hist['val_mse'][-1]:.5f}")
    plot_training_curves(os.path.join(args.out, "training.png"), hist)
    save_checkpoint(os.path.join(args.out, "ckpt"), tstate.params)

    # 3. deploy: nominal vs learned-residual NMPC on the true plant
    net = make_residual_fn(model, tstate.params, tstate.in_scaler, tstate.out_scaler)
    learned = residual_dynamics(unicycle, net)
    # model quality — where the DNN genuinely wins: the one-step rate
    # residual (closed-loop point stabilization is feedback-dominated, so
    # both controllers reach the goal; see tests/test_e2e_dnn_pipeline.py)
    feats = jnp.concatenate([ep.states, ep.controls], axis=-1)
    rms = lambda a: float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))
    print(
        f"one-step model error: nominal {rms(ep.errors / DT):.5f} -> "
        f"DNN residual {rms(ep.errors / DT - net(feats)):.5f}"
    )
    goal = jnp.array([2.0, 1.5, 0.0])
    xs_nom = closed_loop(unicycle, goal)
    xs_dnn = closed_loop(learned, goal)
    e_nom = np.linalg.norm(xs_nom[-1][:2] - np.asarray(goal[:2]))
    e_dnn = np.linalg.norm(xs_dnn[-1][:2] - np.asarray(goal[:2]))
    print(f"final goal error: nominal NMPC {e_nom:.3f} m | DNN-NMPC {e_dnn:.3f} m")

    plot_trajectory(os.path.join(args.out, "nominal.png"), xs_nom, title=f"nominal NMPC (err {e_nom:.2f} m)")
    plot_trajectory(os.path.join(args.out, "dnn.png"), xs_dnn, title=f"DNN-NMPC (err {e_dnn:.2f} m)")
    print(f"artifacts -> {args.out}")


if __name__ == "__main__":
    main()
