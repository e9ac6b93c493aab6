"""Fleet-scale residual-data collection: B MPPI controllers × on-device scan.

The one-program form of the reference's randomized data-collection series
(train/bullet_mpc_differential_drive.py:119-157): B independent scenarios —
each with its own start pose, goal and PRNG stream — run as ONE jitted
vmap(scan) program; the resulting (states, controls, errors) triplets feed
train/training.py directly.

    python examples/fleet_collection.py --scenarios 16 --ticks 100
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc.envs.closed_loop import run_closed_loop
from dnn_mppi_mpc.models import euler_step, unicycle
from dnn_mppi_mpc.paths.generators import line
from dnn_mppi_mpc.solvers.mppi import MPPISolver, MPPIState, make_tracking_costs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=16)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=100)
    args = ap.parse_args()
    B, K, ticks = args.scenarios, args.samples, args.ticks

    dt = 0.05
    cfg = MPPIConfig(
        num_samples=K, horizon=20, dim_x=3, dim_u=2, dt=dt,
        compute_optimal_traj=False,
    )
    step = lambda x, u: euler_step(unicycle, x, u, dt)
    solver = MPPISolver(cfg, step, *make_tracking_costs(cfg))

    # plant with a model error the nominal lacks → residual targets
    def true_step(x, u):
        u_eff = jnp.stack([0.85 * u[..., 0], 0.9 * u[..., 1] + 0.05 * u[..., 0]], -1)
        return euler_step(unicycle, x, u_eff, dt)

    def one_scenario(key):
        k1, k2, k3 = jax.random.split(key, 3)
        start = jax.random.uniform(k1, (2,), minval=-3.0, maxval=3.0)
        goal = jax.random.uniform(k2, (2,), minval=-8.0, maxval=8.0)
        params = MPPIParams(
            sigma=jnp.array([[0.1, 0.0], [0.0, 0.05]]),
            stage_weight=jnp.array([5.0, 5.0, 2.0]),
            terminal_weight=jnp.array([5.0, 5.0, 2.0]),
            u_min=jnp.array([-3.0, -3.14]),
            u_max=jnp.array([3.0, 3.14]),
            ref_path=line(start, goal, 100),
        )

        def controller(cs, x):
            u0, cs, _ = solver._step(params, cs, x, None)
            return u0, cs

        x0 = jnp.concatenate([start, jnp.zeros(1)])
        ep, _ = run_closed_loop(
            controller, true_step, MPPIState.init(cfg, k3), x0, ticks,
            nominal_step=step,
        )
        return ep

    collect = jax.jit(lambda keys: jax.vmap(one_scenario)(keys))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jax.block_until_ready(collect(keys))  # compile + warm-up
    t0 = time.perf_counter()
    ep = jax.block_until_ready(collect(jax.random.split(jax.random.PRNGKey(1), B)))
    wall = time.perf_counter() - t0

    n_solves = B * ticks
    print(
        f"fleet: {B} scenarios × {ticks} ticks (K={K}, T={cfg.horizon}) in {wall:.2f} s"
        f" — {n_solves / wall:,.0f} MPPI solves/s, "
        f"{B * ticks * K * cfg.horizon / wall / 1e9:.1f} G sample-steps/s"
    )
    print(
        f"dataset: states {tuple(np.asarray(ep.states).shape)}, "
        f"mean |residual| {float(jnp.abs(ep.errors).mean()):.4f}"
    )


if __name__ == "__main__":
    main()
