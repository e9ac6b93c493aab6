"""Diff-drive NMPC closed through the actuation-level wheel plant.

The reference's deployment loops never actuate body twist directly — the
NMPC's (v, ω) goes through inverse kinematics to four wheel-speed targets
which PyBullet's velocity-controlled joints track
(simulation/bullet_differential_drive_dnn.py:20-34, 419-467;
train/bullet_mpc_differential_drive.py:40-86). This example closes the same
actuation-level loop in pure JAX: solve → wheel IK → per-wheel lag + delay
+ slip → forward kinematics → pose. The controller's unicycle model never
sees the wheel dynamics, so the run demonstrates robustness to genuine
actuator mismatch.

    python examples/nmpc_wheel_plant.py --ticks 120
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.envs.kinematics import diff_drive_wheel_speeds
from dnn_mppi_mpc.envs.plants import WheelPlant
from dnn_mppi_mpc.presets import diff_drive_nmpc


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--goal", type=float, nargs=3, default=[3.0, 2.0, 1.0])
    ap.add_argument("--tau", type=float, default=0.08, help="wheel lag [s]")
    ap.add_argument("--delay", type=int, default=1, help="command delay ticks")
    ap.add_argument("--slip", type=float, default=0.95)
    args = ap.parse_args()

    dt = 0.05
    goal = jnp.asarray(args.goal, jnp.float32)
    solver, params = diff_drive_nmpc(goal, N=30, dt=dt, sqp_iters=1)
    plant = WheelPlant(
        dt=dt, tau=args.tau, delay_steps=args.delay, slip=args.slip
    )

    ps = plant.init(jnp.zeros(3, jnp.float32))
    st = solver.init(ps.x)
    for t in range(args.ticks):
        u0, st, aux = solver.solve(params, st, ps.x)
        # the loop the reference runs: body command → wheel IK → joints
        wheels = diff_drive_wheel_speeds(u0[0], u0[1], plant.wheel_sep)
        ps = plant.step(ps, wheels)
        if t % 20 == 0:
            d = float(jnp.linalg.norm(ps.x[:2] - goal[:2]))
            print(
                f"tick {t:4d}  pos=({float(ps.x[0]):+.2f}, {float(ps.x[1]):+.2f}) "
                f"yaw={float(ps.x[2]):+.2f}  dist={d:.3f}  "
                f"wheels={np.asarray(ps.wheel_speeds).round(2)}"
            )

    d = float(jnp.linalg.norm(ps.x[:2] - goal[:2]))
    print(f"final distance to goal: {d:.3f} m (wheel-level actuation)")
    if args.ticks >= 100:
        assert d < 0.3, "failed to reach the goal through the wheel plant"


if __name__ == "__main__":
    main()
