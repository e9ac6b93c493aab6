"""Race-car MPPI with polygon obstacle avoidance (reference config 3).

Headless re-creation of controllers/mppi_race_car_obstacle.py:324-343:
lemniscate reference at 5 m/s, kinematic bicycle (L=2.5), two circular
obstacles, λ=50 softmax, padded moving-average smoothing.

    python examples/mppi_racecar_obstacle.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import (
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    Temperature,
)
from dnn_mppi_mpc.models import (
    BicycleParams,
    euler_step,
    kinematic_bicycle,
    kinematic_bicycle_tile,
)
from dnn_mppi_mpc.paths import lemniscate_with_speed
from dnn_mppi_mpc.solvers import MPPISolver, make_tracking_costs
from dnn_mppi_mpc.utils.plotting import plot_controls, plot_trajectory


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument(
        "--scan", action="store_true",
        help="force the XLA scan engine (the default is the GPU rollout kernel "
        "on a GPU, the scan elsewhere)",
    )
    ap.add_argument(
        "--animate",
        action="store_true",
        help="also write the reference-style closed-loop gif "
        "(mppi_race_car_obstacle.py open-loop demo, :324-343)",
    )
    ap.add_argument("--out", default="/tmp/mppi_racecar")
    args = ap.parse_args()

    dt = 0.05
    cfg = MPPIConfig(
        num_samples=args.samples,
        horizon=20,
        dim_x=4,
        dim_u=2,
        dt=dt,
        lam=50.0,
        alpha=1.0,
        exploration=0.01,
        temperature=Temperature.LAMBDA,
        filter=SmoothingFilter.MOVING_AVERAGE_PADDED,
        filter_window=10,
        waypoint_search_len=200,
        compute_optimal_traj=True,  # this example plots the planned trajectory
    )
    ref = lemniscate_with_speed(10.0, 200, speed=5.0)
    params = MPPIParams(
        sigma=jnp.array([[0.5, 0.0], [0.0, 0.1]]),
        stage_weight=jnp.array([50.0, 50.0, 1.0, 20.0]),
        terminal_weight=jnp.array([50.0, 50.0, 1.0, 20.0]),
        u_min=jnp.array([-0.523, -2.0]),
        u_max=jnp.array([0.523, 2.0]),
        ref_path=ref,
        obstacles=jnp.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]]),
    )
    bp = BicycleParams(wheel_base=jnp.asarray(2.5))
    step_fn = lambda x, u: euler_step(lambda s, a: kinematic_bicycle(s, a, bp), x, u, dt)
    stage, terminal = make_tracking_costs(cfg, wrap_yaw=True, collision="polygon")
    solver = MPPISolver(
        cfg, step_fn, stage, terminal, use_pallas=False if args.scan else None,
        tile_dynamics=kinematic_bicycle_tile(dt, 2.5),
    )

    x = jnp.asarray(np.asarray(ref[0], dtype=np.float32))
    state = solver.init(jax.random.PRNGKey(0))
    xs, us, plans = [np.asarray(x)], [], []
    for i in range(args.ticks):
        u0, state, aux = solver.step(params, state, x)
        x = step_fn(x, u0)
        xs.append(np.asarray(x))
        us.append(np.asarray(u0))
        if args.animate:
            plans.append(np.asarray(aux.optimal_traj))
        if i % 50 == 0:
            print(f"tick {i}: pos=({float(x[0]):.2f},{float(x[1]):.2f}) v={float(x[3]):.2f}")

    os.makedirs(args.out, exist_ok=True)
    plot_trajectory(
        os.path.join(args.out, "trajectory.png"),
        np.asarray(xs),
        ref_path=np.asarray(ref),
        obstacles=np.asarray(params.obstacles),
        title="MPPI race car + polygon collision",
    )
    plot_controls(os.path.join(args.out, "controls.png"), np.asarray(us), dt, ["steer [rad]", "accel [m/s²]"])
    if args.animate:
        from dnn_mppi_mpc.utils.plotting import save_animation

        save_animation(
            os.path.join(args.out, "closed_loop.gif"),
            np.asarray(xs),
            ref_path=np.asarray(ref),
            planned_trajs=np.asarray(plans),
            obstacles=np.asarray(params.obstacles),
            fps=10,
            stride=max(1, args.ticks // 100),
            title=f"MPPI race car K={cfg.num_samples}",
        )
    print(f"plots -> {args.out}")


if __name__ == "__main__":
    main()
