"""Diff-drive SQP-RTI NMPC with moving circular obstacles.

Headless re-creation of controllers/mpc_differential_drive_obstacle_dynamic.py:
point stabilization across a field of drifting obstacles, solved by the
jitted Riccati-barrier SQP (the acados/HPIPM replacement).

    python examples/nmpc_obstacle_avoidance.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import dataclasses

import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.envs.obstacles import drift_obstacles
from dnn_mppi_mpc.models import erk_step, unicycle
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, OCPParams, circle_obstacle_h
from dnn_mppi_mpc.utils.plotting import plot_controls, plot_trajectory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--out", default="/tmp/nmpc_obstacles")
    args = ap.parse_args()

    N, dt = 25, 0.1
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=dt, sqp_iters=2, qp_iters=14, n_h_constraints=2)
    solver = NMPCSolver(cfg, unicycle, h_fn=circle_obstacle_h)

    goal = jnp.array([4.0, 3.0, 0.0])
    obstacles0 = jnp.array([[1.5, 1.0, 0.45], [3.0, 2.4, 0.45]])
    vels = jnp.array([[0.02, 0.01], [-0.015, 0.01]])
    base = OCPParams(
        Q=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        R=jnp.diag(jnp.array([0.5, 0.05])),
        Qe=jnp.diag(jnp.array([10.0, 10.0, 0.1])),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.full(3, -10.0),
        ubx=jnp.full(3, 10.0),
        lbu=jnp.array([-1.0, -1.0]),
        ubu=jnp.array([1.0, 1.0]),
        p=obstacles0,
    )

    x = jnp.zeros(3)
    state = solver.init(x)
    xs, us, margins = [np.zeros(3)], [], []
    for i in range(args.ticks):
        obs = drift_obstacles(obstacles0, vels, jnp.asarray(i * dt))
        params = dataclasses.replace(base, p=obs)
        u0, state, aux = solver.solve(params, state, x)
        x = erk_step(unicycle, x, u0, dt, num_steps=3)
        xs.append(np.asarray(x))
        us.append(np.asarray(u0))
        # actual plant clearance (predicted-horizon h_margin can dip negative
        # on warm-start tails before the solver re-plans): distance to the
        # obstacle BOUNDARY — center distance minus radius, negative inside
        clear = float(
            jnp.min(
                jnp.linalg.norm(x[:2][None, :] - obs[:, :2], axis=1) - obs[:, 2]
            )
        )
        margins.append(clear)
        if i % 25 == 0:
            print(
                f"tick {i}: pos=({float(x[0]):.2f},{float(x[1]):.2f}) "
                f"h_margin={float(aux.h_margin):.3f} defect={float(aux.defect):.1e}"
            )

    err = float(jnp.linalg.norm(x[:2] - goal[:2]))
    print(f"final goal error: {err:.3f} m, min obstacle clearance: {min(margins):.3f} m")
    os.makedirs(args.out, exist_ok=True)
    plot_trajectory(
        os.path.join(args.out, "trajectory.png"),
        np.asarray(xs),
        obstacles=np.asarray(obstacles0),
        title="SQP-RTI NMPC, moving obstacles",
    )
    plot_controls(os.path.join(args.out, "controls.png"), np.asarray(us), dt, ["v", "ω"])
    print(f"plots -> {args.out}")


if __name__ == "__main__":
    main()
