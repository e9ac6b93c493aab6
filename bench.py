"""Benchmark: MPPI solves/s at K=10 240, T=50 (diff-drive flagship) on a GPU.

    python bench.py                    # flagship: ONE JSON line
    python bench.py --suite            # every row of utils/benchsuite.py
    python bench.py --suite racecar,nmpc_rti --compare   # kernel vs XLA path

The control tick (solver step + plant step) is chained on the device and
timed to ``block_until_ready`` (utils/benchtime.py). ``vs_baseline`` is the
achieved control rate over the 50 Hz real-time budget (the reference
publishes no absolute numbers — BASELINE.md). Every result names the device
it ran on; without a GPU the benchmark fails instead of measuring the CPU.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp

from dnn_mppi_mpc.utils.platform import enable_compilation_cache, require_gpu


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10240, help="rollout count")
    ap.add_argument("--t", type=int, default=50, help="horizon")
    ap.add_argument("--n", type=int, default=1000, help="ticks per timed chain")
    ap.add_argument("--reps", type=int, default=20, help="timed chains")
    ap.add_argument(
        "--suite", nargs="?", const="all", default=None,
        help="measure every suite row (one JSON line each), or a "
        "comma-separated subset, e.g. --suite racecar,nmpc_rti",
    )
    ap.add_argument(
        "--compare", action="store_true",
        help="with --suite: time each kernel row on the kernel and on the "
        "plain XLA path, alternating",
    )
    args = ap.parse_args()
    require_gpu()
    enable_compilation_cache()

    if args.suite:
        from dnn_mppi_mpc.utils.benchsuite import run_suite

        rows = None if args.suite == "all" else tuple(args.suite.split(","))
        run_suite(rows=rows, reps=args.reps, compare=args.compare)
        return

    from __graft_entry__ import _flagship
    from dnn_mppi_mpc.models.tile import unicycle_tile
    from dnn_mppi_mpc.solvers.mppi import MPPISolver
    from dnn_mppi_mpc.utils.benchtime import chain_timing, scan_chain_runner

    K, T = args.k, args.t
    cfg, params, step_fn, stage, terminal = _flagship(K, T)
    solver = MPPISolver(cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(cfg.dt))

    def body(params, state, x):
        u0, state, aux = solver._step(params, state, x, None)
        return (state, step_fn(x, u0)), aux.costs[0]

    st0, x0 = solver.init(), jnp.zeros((3,), jnp.float32)
    t = chain_timing(lambda n: scan_chain_runner(body, params, st0, x0, n), args.n, args.reps)
    budget_hz = 50.0
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"mppi_solves_per_s_K{K}_T{T}_diffdrive",
        "value": t.ticks_per_s,
        "unit": "solves/s",
        "vs_baseline": t.ticks_per_s / budget_hz,
        "per_solve_ms_best": t.best * 1e3,
        "p50_ms": t.p50 * 1e3,
        "p99_ms": t.p99 * 1e3,
        "meets_50hz_budget": bool(t.p99 < 1.0 / budget_hz),
        "K": K,
        "T": T,
        "path": "kernel" if solver.rollout_fn is not None else "xla_scan",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
