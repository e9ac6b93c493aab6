"""Diff-drive waypoint-tracking MPPI demo (reference config 1).

Headless re-creation of controllers/mppi_differential_drive.py:392-443:
straight-line reference to (10, −5), K=100, T=10 at 10 Hz, Euler plant;
saves trajectory + control plots instead of an mp4.

    python examples/mppi_diffdrive.py [--ticks 300] [--scan]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams, SmoothingFilter, Temperature
from dnn_mppi_mpc.models import euler_step, unicycle, unicycle_tile
from dnn_mppi_mpc.paths import line
from dnn_mppi_mpc.solvers import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.utils import Timer
from dnn_mppi_mpc.utils.plotting import plot_controls, plot_trajectory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument(
        "--scan", action="store_true",
        help="force the XLA scan engine (the default is the GPU rollout kernel "
        "on a GPU, the scan elsewhere)",
    )
    ap.add_argument(
        "--animate",
        action="store_true",
        help="also write an animated closed-loop gif (the reference's "
        "FuncAnimation artifact, mppi_differential_drive.py:291-372)",
    )
    ap.add_argument("--out", default="/tmp/mppi_diffdrive")
    args = ap.parse_args()

    dt = 0.1
    cfg = MPPIConfig(
        num_samples=args.samples,
        horizon=args.horizon,
        dim_x=3,
        dim_u=2,
        dt=dt,
        lam=1.0,
        alpha=0.2,
        exploration=0.0001,
        temperature=Temperature.EXPLORATION,
        filter=SmoothingFilter.MOVING_AVERAGE_EDGE,
        filter_window=min(10, args.horizon),
        compute_optimal_traj=True,  # this example plots the planned trajectory
    )
    ref = line(jnp.zeros(2), jnp.array([10.0, -5.0]), 100)
    params = MPPIParams(
        sigma=jnp.array([[0.1, 0.0], [0.0, 0.01]]),
        stage_weight=jnp.array([5.0, 5.0, 10.0]),
        terminal_weight=jnp.array([5.0, 5.0, 10.0]),
        u_min=jnp.array([-5.0, -3.14]),
        u_max=jnp.array([5.0, 3.14]),
        ref_path=ref,
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, dt)
    solver = MPPISolver(
        cfg, step_fn, *make_tracking_costs(cfg),
        use_pallas=False if args.scan else None, tile_dynamics=unicycle_tile(dt),
    )

    x = jnp.zeros(3)
    state = solver.init(jax.random.PRNGKey(0))
    xs, us, plans = [np.zeros(3)], [], []
    timer = Timer()
    for i in range(args.ticks):
        with timer:
            u0, state, aux = solver.step(params, state, x)
            jax.block_until_ready(u0)
        x = step_fn(x, u0)
        xs.append(np.asarray(x))
        us.append(np.asarray(u0))
        if args.animate:
            plans.append(np.asarray(aux.optimal_traj))
        if i % 50 == 0:
            print(f"tick {i}: x={np.round(np.asarray(x), 3)} u={np.round(np.asarray(u0), 3)}")

    os.makedirs(args.out, exist_ok=True)
    plot_trajectory(
        os.path.join(args.out, "trajectory.png"),
        np.asarray(xs),
        ref_path=np.asarray(ref),
        optimal_traj=np.asarray(aux.optimal_traj),
        title=f"MPPI diff-drive K={cfg.num_samples} T={cfg.horizon}",
    )
    plot_controls(os.path.join(args.out, "controls.png"), np.asarray(us), dt, ["v [m/s]", "ω [rad/s]"])
    if args.animate:
        from dnn_mppi_mpc.utils.plotting import save_animation

        save_animation(
            os.path.join(args.out, "closed_loop.gif"),
            np.asarray(xs),
            ref_path=np.asarray(ref),
            planned_trajs=np.asarray(plans),
            fps=10,
            stride=max(1, args.ticks // 100),
            title=f"MPPI diff-drive K={cfg.num_samples}",
        )
    print("timing:", {k: round(v, 3) for k, v in timer.summary().items()})
    print(f"plots -> {args.out}")


if __name__ == "__main__":
    main()
