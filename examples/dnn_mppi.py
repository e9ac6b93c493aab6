"""DNN-MPPI pipeline: MPPI-driven collection → residual MLP → MPPI deploy.

The sampling-based counterpart of examples/dnn_nmpc_pipeline.py, and the loop
the reference never closes: train/bullet_mppi_differential_drive.py:222-283
collects Husky data *with* a batched MPPI controller and train/train_diff_mlp.py
fits the residual, but the learned model is only ever deployed under acados
NMPC. Here the trained residual plugs straight back into the MPPI engine
(dynamics_step is any JAX function; the K-batched MLP rollout is a chain of
(K, hidden) matrix products inside the scan).

    python examples/dnn_mppi.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc.envs.closed_loop import (
    collect_residual_dataset,
    mppi_controller,
    run_closed_loop,
)
from dnn_mppi_mpc.models import euler_step, unicycle
from dnn_mppi_mpc.models.learned import (
    MLP,
    ResNet1D,
    make_residual_fn,
    residual_from_train_state,
)
from dnn_mppi_mpc.paths import line
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.train.checkpoint import save_checkpoint
from dnn_mppi_mpc.train.training import TrainConfig, train_residual_model
from dnn_mppi_mpc.utils.benchtime import chain_timing
from dnn_mppi_mpc.utils.plotting import plot_training_curves, plot_trajectory

DT = 0.05


def plant_step(x, u):
    """The 'real robot': wheel slip + speed-coupled yaw error the nominal
    unicycle misses (the Husky-vs-model gap of the reference's dataset)."""
    u_eff = jnp.stack([0.7 * u[..., 0], 0.85 * u[..., 1] + 0.25 * u[..., 0]], -1)
    return euler_step(unicycle, x, u_eff, DT)


def nominal_step(x, u):
    return euler_step(unicycle, x, u, DT)


def make_solver(dynamics_step, K, horizon, ref_path):
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
        ref_path=ref_path,
    )
    return MPPISolver(cfg, dynamics_step, *make_tracking_costs(cfg)), params


def tracking_run(dynamics_step, ref_path, ticks, K, horizon):
    solver, params = make_solver(dynamics_step, K, horizon, ref_path)
    episode, _ = run_closed_loop(
        mppi_controller(solver, params), plant_step, solver.init(),
        jnp.array([0.0, 0.8, 0.0], jnp.float32), ticks,
    )
    xy = np.asarray(episode.states[:, :2], np.float64)
    path = np.asarray(ref_path[:, :2], np.float64)
    d = np.linalg.norm(xy[:, None, :] - path[None, :, :], axis=-1).min(axis=1)
    return np.asarray(episode.states), float(np.sqrt(np.mean(d[ticks // 2:] ** 2)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/dnn_mppi")
    ap.add_argument("--series", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument(
        "--hidden", type=int, default=128,
        help="residual MLP width (the reference deploys 512: "
        "simulation/bullet_differential_drive_dnn.py:37-60)",
    )
    ap.add_argument(
        "--model", choices=["mlp", "resnet18", "resnet50"], default="mlp",
        help="residual regressor family — the conv ResNets are the "
        "reference's train_diff_resnet18/50.py models as controller "
        "dynamics (BASELINE config 5)",
    )
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    ref_path = line(jnp.zeros(2), jnp.array([6.0, 3.0]), num_points=160)

    # 1. collect with MPPI driving the real plant (reference collection #2,
    #    train/bullet_mppi_differential_drive.py — K=50, T=5 there)
    def factory(key):
        solver, params = make_solver(nominal_step, 128, 10, ref_path)
        return mppi_controller(solver, params), solver.init()

    def x0_sampler(key):
        return jax.random.uniform(
            key, (3,), jnp.float32,
            jnp.array([-0.5, -0.5, -0.8]), jnp.array([0.5, 1.0, 0.8]),
        )

    data = collect_residual_dataset(
        factory, plant_step, nominal_step, x0_sampler,
        jax.random.PRNGKey(0), args.series, 80,
    )
    print(f"collected {data.states.shape[0]} MPPI-driven samples")

    # 2. residual regression (train/train_diff_mlp.py loop, in-graph scalers)
    if args.model == "mlp":
        model = MLP(out_dim=3, hidden=args.hidden, depth=2)
    else:
        model = ResNet1D(out_dim=3, variant=args.model[-2:])
    tstate, hist = train_residual_model(
        model, data.states, data.controls, data.errors,
        TrainConfig(num_epochs=args.epochs, batch_size=256, learning_rate=2e-3),
    )
    print(f"train mse {hist['train_mse'][-1]:.5f}  val mse {hist['val_mse'][-1]:.5f}")
    plot_training_curves(os.path.join(args.out, "training.png"), hist)
    save_checkpoint(os.path.join(args.out, "ckpt"), tstate.params)

    net = residual_from_train_state(model, tstate)  # handles MLP and conv ResNets

    def corrected_step(x, u):
        return nominal_step(x, u) + net(jnp.concatenate([x, u], axis=-1))

    feats = jnp.concatenate([data.states, data.controls], axis=-1)
    rms = lambda a: float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))
    print(
        f"one-step model error on visited distribution: "
        f"nominal {rms(data.errors):.5f} -> corrected "
        f"{rms(data.errors - net(feats)):.5f}"
    )

    # 3. deploy: MPPI over nominal vs corrected model on the real plant
    xs_nom, rmse_nom = tracking_run(nominal_step, ref_path, 200, args.samples, args.horizon)
    xs_dnn, rmse_dnn = tracking_run(corrected_step, ref_path, 200, args.samples, args.horizon)
    print(f"steady-state tracking RMSE: nominal {rmse_nom:.3f} m | DNN-MPPI {rmse_dnn:.3f} m")
    plot_trajectory(
        os.path.join(args.out, "nominal.png"), xs_nom,
        ref_path=np.asarray(ref_path), title=f"nominal MPPI (rmse {rmse_nom:.2f} m)",
    )
    plot_trajectory(
        os.path.join(args.out, "dnn.png"), xs_dnn,
        ref_path=np.asarray(ref_path), title=f"DNN-MPPI (rmse {rmse_dnn:.2f} m)",
    )

    # 4. throughput of the learned-dynamics MPPI tick (XLA scan)
    def bench_tick(dynamics_step, label):
        solver, params = make_solver(
            dynamics_step, args.samples, args.horizon, ref_path
        )
        core, dyn = solver._step, solver.dynamics_step
        c0 = (solver.init(), jnp.zeros(3, jnp.float32))

        def make_runner(n):
            @jax.jit
            def run_chain(carry):
                def body(c, _):
                    st, x = c
                    u0, st, aux = core(params, st, x, None)
                    return (st, dyn(x, u0)), aux.costs[0]
                c, ys = jax.lax.scan(body, carry, None, length=n)
                return ys

            return lambda: run_chain(c0)

        tau = chain_timing(make_runner, 50, 5).p50
        dev = jax.devices()[0]
        print(
            f"DNN-MPPI (K={args.samples}, T={args.horizon}, "
            + (
                f"MLP 5-{args.hidden}-{args.hidden}-3, "
                if args.model == "mlp"
                else f"{args.model} conv residual, "
            )
            + f"{label}): {tau*1e3:.3f} ms/solve ({1/tau:.0f} solves/s) "
            f"on {dev.platform} ({dev.device_kind})"
        )
        return tau

    bench_tick(corrected_step, f"XLA scan ({args.model})")
    print(f"artifacts -> {args.out}")


if __name__ == "__main__":
    main()
