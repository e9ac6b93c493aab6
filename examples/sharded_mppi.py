"""Sample-sharded MPPI across a device mesh.

Runs the flagship diff-drive MPPI with the K rollout dimension sharded over
all available devices (GPUs, each shard on the rollout kernel, or a virtual
CPU mesh via
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``).

    python examples/sharded_mppi.py --samples 16384
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _flagship
from dnn_mppi_mpc.models.tile import unicycle_tile
from dnn_mppi_mpc.parallel.sharding import make_mesh, make_sharded_mppi_step
from dnn_mppi_mpc.solvers.mppi import MPPISolver, MPPIState


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=16384)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--ticks", type=int, default=100)
    args = ap.parse_args()

    n_dev = jax.device_count()
    K = args.samples - (args.samples % n_dev)
    print(f"devices: {n_dev} × {jax.devices()[0].platform}; K={K} (={K // n_dev}/device)")

    cfg, params, step_fn, stage, terminal = _flagship(K, args.horizon)
    mesh = make_mesh(("k",))
    rollout_fn = MPPISolver(
        cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(cfg.dt)
    ).rollout_fn
    step = make_sharded_mppi_step(cfg, step_fn, stage, terminal, mesh, rollout_fn=rollout_fn)

    state = MPPIState.init(cfg)
    x = jnp.zeros(3, jnp.float32)
    u0, state, aux = step(params, state, x)
    jax.block_until_ready(u0)

    t0 = time.perf_counter()
    for _ in range(args.ticks):
        u0, state, aux = step(params, state, x)
        x = x + 0.0  # keep x fixed; state carries the solver
    jax.block_until_ready(u0)
    dt = (time.perf_counter() - t0) / args.ticks
    print(
        f"{dt * 1e6:.1f} us/solve  |  {1 / dt:,.0f} solves/s  |  "
        f"{K * args.horizon / dt / 1e9:.2f} G sample-steps/s"
    )
    print("u0 =", np.round(np.asarray(u0), 4), " finite:", bool(jnp.all(jnp.isfinite(u0))))


if __name__ == "__main__":
    main()
