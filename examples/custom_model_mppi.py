"""Custom-model MPPI on the GPU rollout kernel.

Demonstrates the framework capability the reference has no counterpart for:
*any* dynamics model on the one-launch rollout path. Here the four-wheel
torque-input model (mpc_differential_dynamics.py:98-105 — in the reference
this model only appears behind acados NMPC) is driven by MPPI with obstacle
avoidance: the tile step (models/tile.py) is traced straight into the
rollout kernel on a GPU (the XLA scan runs it elsewhere).

    python examples/custom_model_mppi.py [--ticks 200] [--scan]

``--scan`` forces the XLA scan engine on a GPU too.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc.models import (
    euler_step,
    four_wheel_torque,
    four_wheel_torque_tile,
)
from dnn_mppi_mpc.paths import line
from dnn_mppi_mpc.solvers import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.utils import Timer
from dnn_mppi_mpc.utils.plotting import plot_controls, plot_trajectory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--scan", action="store_true", help="XLA scan engine")
    ap.add_argument("--out", default="/tmp/custom_model_mppi")
    args = ap.parse_args()

    dt = 0.05
    cfg = MPPIConfig(
        num_samples=args.samples,
        horizon=args.horizon,
        dim_x=5,
        dim_u=4,
        dt=dt,
        lam=1.0,
        exploration=0.1,
        waypoint_search_len=20,
    )
    # 4-column reference (x, y, yaw, v_ref): tracking a reference *speed*
    # gives the torque-input model its progress incentive (v is a state with
    # inertia here, not a control like the diff-drive's).
    path_xy = line(jnp.zeros(2), jnp.array([8.0, -4.0]), num_points=200)
    v_ref = jnp.full((path_xy.shape[0], 1), 1.5, jnp.float32)
    params = MPPIParams(
        sigma=jnp.asarray(0.6 * np.eye(4), jnp.float32),
        stage_weight=jnp.array([8.0, 8.0, 1.0, 3.0], jnp.float32),
        terminal_weight=jnp.array([12.0, 12.0, 2.0, 3.0], jnp.float32),
        u_min=jnp.full((4,), -2.5, jnp.float32),
        u_max=jnp.full((4,), 2.5, jnp.float32),
        ref_path=jnp.concatenate([path_xy[:, :3], v_ref], axis=1),
        obstacles=jnp.array([[3.0, -1.2, 0.5], [5.5, -3.0, 0.5]], jnp.float32),
    )
    step_fn = lambda x, u: euler_step(four_wheel_torque, x, u, dt)
    stage, terminal = make_tracking_costs(cfg, collision="circle", robot_radius=0.4)

    # the solver picks the rollout kernel on a GPU, the scan elsewhere
    solver = MPPISolver(
        cfg,
        step_fn,
        stage,
        terminal,
        use_pallas=False if args.scan else None,
        tile_dynamics=four_wheel_torque_tile(dt),
    )
    kernel = solver.rollout_fn is not None

    state = solver.init()
    x = jnp.zeros((5,), jnp.float32)
    xs, us = [np.asarray(x)], []
    timer = Timer()
    for _ in range(args.ticks):
        with timer:
            u0, state, aux = solver.step(params, state, x)
            u0.block_until_ready()
        x = step_fn(x, u0)
        xs.append(np.asarray(x))
        us.append(np.asarray(u0))
        if int(aux.status) & 1:
            break
    xs, us = np.stack(xs), np.stack(us)

    os.makedirs(args.out, exist_ok=True)
    plot_trajectory(
        os.path.join(args.out, "trajectory.png"),
        xs,
        ref_path=np.asarray(params.ref_path),
        obstacles=np.asarray(params.obstacles),
        title=f"four-wheel torque MPPI ({'kernel' if kernel else 'scan'})",
    )
    plot_controls(os.path.join(args.out, "controls.png"), us, dt)
    err = np.hypot(xs[-1, 0] - 8.0, xs[-1, 1] + 4.0)
    print(
        f"{len(us)} ticks, final ({xs[-1,0]:.2f}, {xs[-1,1]:.2f}), "
        f"dist-to-goal {err:.2f} m, {timer.summary()}"
    )


if __name__ == "__main__":
    main()
