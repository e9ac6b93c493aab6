"""Fleet MPPI serving: B controllers per card, one rollout launch per tick.

The MPPI counterpart of examples/nmpc_fleet_serving.py — a whole fleet of
independent diff-drive MPPI controllers (per-member reference path, state,
and PRNG stream) ticks as one vmapped ``mppi_step``; on a GPU the vmapped
rollout kernel is one launch for the whole fleet (a grid axis per member).
The reference's analog runs one controller process per robot
(train/bullet_mpc_differential_drive.py:119-157 collects series
sequentially). On a CPU the same fleet runs the scan path.

    python examples/mppi_fleet_serving.py --fleet 16 --samples 1024 --bench
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import MPPIConfig, MPPIParams
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import euler_step
from dnn_mppi_mpc.models.tile import unicycle_tile
from dnn_mppi_mpc.paths import line
from dnn_mppi_mpc.solvers.mppi import MPPISolver, MPPIState, make_tracking_costs
from dnn_mppi_mpc.utils.benchtime import chain_timing, scan_chain_runner


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=16)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--bench", action="store_true")
    ap.add_argument(
        "--sharded",
        action="store_true",
        help="partition the fleet over a device mesh (make_sharded_mppi_fleet; "
        "zero collectives, the rollout kernel kept per shard) — on one card "
        "this is the 1-shard A/B vs the unsharded launch",
    )
    args = ap.parse_args()

    B, dt = args.fleet, 0.05
    cfg = MPPIConfig(
        num_samples=args.samples, horizon=args.horizon,
        dim_x=3, dim_u=2, dt=dt, waypoint_search_len=20,
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, dt)

    rng = np.random.default_rng(0)
    goals = rng.uniform(-4, 4, (B, 2)).astype(np.float32)
    paths = jnp.stack(
        [line(jnp.zeros(2), jnp.asarray(g), num_points=80) for g in goals]
    )
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.0], [0.0, 0.1]], jnp.float32),
        stage_weight=jnp.array([8.0, 8.0, 2.0], jnp.float32),
        terminal_weight=jnp.array([8.0, 8.0, 2.0], jnp.float32),
        u_min=jnp.array([-3.0, -3.14], jnp.float32),
        u_max=jnp.array([3.0, 3.14], jnp.float32),
        ref_path=paths,  # (B, P, 3): per-member references
    )

    stage, terminal = make_tracking_costs(cfg)
    solver = MPPISolver(cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(dt))
    path = "rollout kernel" if solver.rollout_fn is not None else "scan path"
    if args.sharded:
        from dnn_mppi_mpc.parallel import make_mesh, make_sharded_mppi_fleet

        mesh = make_mesh(("batch",))
        fleet = make_sharded_mppi_fleet(
            cfg, step_fn, stage, terminal, mesh, axis="batch",
            rollout_fn=solver.rollout_fn,
        )
        mode = f"mesh-sharded fleet over {mesh.shape['batch']} device(s), {path}"
    else:

        @jax.jit
        def fleet(p, states, xs):
            def member(path, st, x):
                return solver._step(dataclasses.replace(p, ref_path=path), st, x, None)

            return jax.vmap(member)(p.ref_path, states, xs)

        mode = f"vmapped fleet, {path}"

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    states = jax.vmap(lambda k: MPPIState.init(cfg, k))(keys)
    xs = jnp.zeros((B, 3), jnp.float32)

    for _ in range(args.ticks):
        u0s, states, auxs = fleet(params, states, xs)
        xs = jax.vmap(step_fn)(xs, u0s)
    d = np.array(
        [
            np.linalg.norm(
                np.asarray(paths[b][:, :2]) - np.asarray(xs[b, :2]), axis=1
            ).min()
            for b in range(B)
        ]
    )
    print(
        f"fleet={B} [{mode}]: max distance-to-path after {args.ticks} ticks "
        f"= {d.max():.3f} m (median {np.median(d):.3f})"
    )

    if args.bench:
        st0 = jax.vmap(lambda k: MPPIState.init(cfg, k))(keys)

        def body(p, st, x):
            u0s, st, auxs = fleet(p, st, x)
            return (st, jax.vmap(step_fn)(x, u0s)), auxs.costs[:, 0]

        x0 = jnp.zeros((B, 3), jnp.float32)
        t = chain_timing(lambda n: scan_chain_runner(body, params, st0, x0, n), 50, 5)
        dev = jax.devices()[0]
        print(
            json.dumps(
                {
                    "metric": f"mppi_fleet_tick_B{B}_K{args.samples}"
                    + ("_sharded" if args.sharded else ""),
                    "fleet_ticks_per_s": t.ticks_per_s,
                    "member_solves_per_s": B * t.ticks_per_s,
                    "per_tick_ms_p50": t.p50 * 1e3,
                    "path": path,
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                }
            )
        )


if __name__ == "__main__":
    main()
