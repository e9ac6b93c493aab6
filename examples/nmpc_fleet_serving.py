"""Fleet NMPC serving: B controllers per card on the fleet QP kernel.

The production-serving shape the reference cannot express (it runs ONE
acados process per robot — e.g. the per-robot solver loop of
simulation/bullet_differential_drive_dnn.py:419-467): here a whole fleet of
independent diff-drive NMPC problems — per-member start, goal, and obstacle
field — solves as ONE program per control tick. On a GPU the fleet is one
barrier-Riccati kernel launch, one member per thread
(ops/pallas/riccati_qp.py::pallas_batched_barrier_qp_solve, dispatched by
NMPCSolver.batched_solve's custom_vmap rule); ``--backend xla`` runs the
batched XLA Riccati for comparison.

Reports fleet-ticks/s and solves/s of an on-device chain of ticks
(utils/benchtime.py), plus a correctness summary (all members reach their
goals).

    python examples/nmpc_fleet_serving.py --fleet 64 --bench
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.presets import diff_drive_nmpc
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, NMPCState, circle_obstacle_h
from dnn_mppi_mpc.utils.benchtime import chain_timing


def build_fleet(fleet: int, N: int, backend: str, rng):
    """B independent OCPs: random starts, goals on a circle, one obstacle
    between each start and its goal (per-member h-constraint params)."""
    base_solver, base_params = diff_drive_nmpc(
        jnp.zeros(3, jnp.float32),
        N=N,
        obstacles=jnp.array([[1.0, 0.0, 0.3]], jnp.float32),
    )
    cfg = dataclasses.replace(base_solver.cfg, qp_backend=backend)
    solver = NMPCSolver(cfg, unicycle, h_fn=circle_obstacle_h)

    ang = rng.uniform(0, 2 * np.pi, fleet)
    goals = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang), ang], axis=1)
    x0s = rng.uniform(-0.3, 0.3, (fleet, 3))
    obs = np.concatenate(
        [0.55 * goals[:, :2], np.full((fleet, 1), 0.25)], axis=1
    )[:, None, :]  # (B, 1, 3) one mid-route obstacle each

    def member_params(goal, ob):
        yref = jnp.concatenate([goal, jnp.zeros(2, jnp.float32)])
        return dataclasses.replace(
            base_params,
            yref=jnp.broadcast_to(yref, (N, 5)),
            yref_e=goal,
            p=ob,  # (n_obs, 3) circle rows, preset layout
        )

    params = jax.vmap(member_params)(
        jnp.asarray(goals, jnp.float32), jnp.asarray(obs, jnp.float32)
    )
    x0s = jnp.asarray(x0s, jnp.float32)
    states = jax.vmap(lambda x: NMPCState.init(cfg, x))(x0s)
    return solver, params, states, x0s, goals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument(
        "--backend", choices=["pallas", "xla"], default=None,
        help="QP backend (default: the kernel on a GPU, XLA elsewhere)",
    )
    ap.add_argument("--bench", action="store_true", help="time the fleet tick")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    solver, params, states, x0s, goals = build_fleet(
        args.fleet, args.horizon, args.backend, rng
    )
    backend = solver.cfg.qp_backend  # resolved by the platform when unset
    fleet_solve = solver.batched_solve()
    plant = jax.jit(jax.vmap(solver.dyn_step))

    # -- closed loop: every member must reach its own goal ------------------
    xs, st = x0s, states
    for _ in range(args.ticks):
        u0s, st, aux = fleet_solve(params, st, xs)
        xs = plant(xs, u0s)
    dists = np.linalg.norm(np.asarray(xs[:, :2]) - goals[:, :2], axis=1)
    print(
        f"fleet={args.fleet} backend={backend}: "
        f"max goal distance after {args.ticks} ticks = {dists.max():.3f} m "
        f"(median {np.median(dists):.3f}), "
        f"max |kkt| {float(jnp.max(aux.kkt_residual)):.2e}"
    )
    if not (dists < 0.5).all():
        print("WARNING: not all members converged", dists)

    # -- fleet-tick rate (on-device chain) ----------------------------------
    if args.bench:
        def make_runner(n):
            # the scan closes over the *core* (un-jitted) fleet solve
            core = jax.vmap(solver._core)

            @jax.jit
            def chain(st0, xs0):
                def body(carry, _):
                    st, xs = carry
                    u0s, st, _ = core(params, st, xs)
                    xs = jax.vmap(solver.dyn_step)(xs, u0s)
                    return (st, xs), u0s[0, 0]
                (st, xs), ys = jax.lax.scan(body, (st0, xs0), None, length=n)
                return xs, ys

            return lambda: chain(states, x0s)

        t = chain_timing(make_runner, 10, 5)
        dev = jax.devices()[0]
        print(
            json.dumps(
                {
                    "metric": f"nmpc_fleet_tick_B{args.fleet}_N{args.horizon}_{backend}",
                    "fleet_ticks_per_s": t.ticks_per_s,
                    "solves_per_s": t.ticks_per_s * args.fleet,
                    "per_tick_ms_p50": t.p50 * 1e3,
                    "per_tick_ms_p99": t.p99 * 1e3,
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                }
            )
        )


if __name__ == "__main__":
    main()
