"""One-process end-to-end realtime pipeline measurement on a GPU.

The BASELINE latency metric measured for real: a single process drives

    native RatePacer (absolute deadlines, runtime/src/dmmrt.cpp)
      → flagship MPPI tick (MPPISolver's default GPU path)
      → JAX plant step (the AcadosSim/PyBullet role), in the same dispatch

for N ticks at a fixed rate, recording per-tick solve time (dispatch to
``block_until_ready``) and per-deadline lateness — per-tick tails, not
chain averages. Replaces the reference's deployment loop
simulation/bullet_differential_drive_dnn.py:419-467 (read state → solve →
actuate → sleep).

Outputs one JSON-able dict (see ``run_realtime_e2e``), printed by
``python -m dnn_mppi_mpc realtime``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def run_realtime_e2e(
    hz: float = 50.0,
    ticks: int = 10_000,
    K: int = 10_240,
    T: int = 50,
    seed: int = 0,
    fused_plant: bool = True,
) -> dict:
    """Drive pacer + controller + plant in this process; return miss stats.

    A deadline miss is a tick whose pacer wake-up was late by more than 10%
    of the period (the pacer sleeps on absolute deadlines, so lateness > 0
    means the previous tick's work overran its slot; the 10% guard separates
    genuine overruns from scheduler wake-up jitter). ``misses_per_10k`` is
    that count normalized to 10 000 ticks — the regression-bound metric.
    """
    from ..utils.platform import enable_compilation_cache, require_gpu

    require_gpu()
    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from ..models.tile import unicycle_tile
    from ..solvers.mppi import MPPISolver
    from .loop import RealtimeLoop

    import os
    import sys

    # flagship config lives next to the repo root (driver contract)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    try:
        from __graft_entry__ import _flagship
    finally:
        sys.path.pop(0)

    cfg, params, step_fn, stage, terminal = _flagship(K, T)
    solver = MPPISolver(cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(cfg.dt))

    import jax.random as jrandom

    state_holder = [solver.init(jrandom.PRNGKey(seed))]
    x_holder = [jnp.zeros((3,), jnp.float32)]

    def read_state():
        return x_holder[0]

    if fused_plant:
        # Solve + plant as ONE AOT-compiled dispatch per tick, with the
        # carried (state, x) buffers DONATED so XLA reuses them in place —
        # no second per-tick dispatch, no jit call-cache lookup on the hot
        # path.
        # solver._step is the jitted step; wrap it in one jit with donation,
        # then AOT-compile so the per-tick call path is a plain compiled
        # executable invocation.
        def _tick(params_, st_, x_):
            u0, st2, _aux = solver._step(params_, st_, x_, None)
            return u0, st2, step_fn(x_, u0)

        compiled = (
            jax.jit(_tick, donate_argnums=(1, 2))
            .lower(params, state_holder[0], x_holder[0])
            .compile()
        )

        def controller(x):
            u0, st, xn = compiled(params, state_holder[0], x_holder[0])
            state_holder[0] = st
            x_holder[0] = xn
            u0.block_until_ready()
            return u0

        def apply_control(u):
            pass  # the plant advanced inside the fused dispatch
    else:
        plant_step = jax.jit(step_fn)

        def controller(x):
            u0, st, _ = solver.step(params, state_holder[0], x)
            state_holder[0] = st
            u0.block_until_ready()
            return u0

        def apply_control(u):
            # async enqueue; its readiness folds into the next tick's block
            x_holder[0] = plant_step(x_holder[0], u)

    cap = 1 << max(14, int(np.ceil(np.log2(max(ticks, 2)))))
    loop = RealtimeLoop(
        controller, read_state, apply_control, hz=hz,
        telemetry_capacity=cap, convert_arrays=False,
        warmup_apply=True,  # plant is a simulator — compile it pre-pacing
    )
    try:
        pacer_stats = loop.run(ticks)
        rec = loop.drain_telemetry()
    finally:
        loop.close()

    period_ns = 1e9 / hz
    solve_ms = rec["solve_ns"] / 1e6
    late_ns = rec["late_ns"]
    misses = int(np.sum(late_ns > 0.1 * period_ns))
    dev = jax.devices()[0]
    return {
        "metric": "realtime_e2e",
        "hz": hz,
        "ticks": int(rec.shape[0]),
        "K": K,
        "T": T,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "solver_path": "kernel" if solver.rollout_fn is not None else "xla_scan",
        # per tick: dispatch of solve + plant to completion
        "solve_p50_ms": float(np.percentile(solve_ms, 50)),
        "solve_p99_ms": float(np.percentile(solve_ms, 99)),
        "solve_max_ms": float(solve_ms.max()),
        "late_p50_ms": float(np.percentile(late_ns, 50)) / 1e6,
        "late_p99_ms": float(np.percentile(late_ns, 99)) / 1e6,
        "late_max_ms": float(late_ns.max()) / 1e6,
        "misses_per_10k": misses * 10_000 / max(rec.shape[0], 1),
        "pacer_overruns": int(pacer_stats["overruns"]),
        "rt_scheduling": bool(pacer_stats.get("rt_scheduling", False)),
        "meets_budget_p99": bool(
            np.percentile(solve_ms, 99) < 1e3 / hz
            and np.percentile(late_ns, 99) < 0.1 * period_ns
        ),
    }


def main(argv: Optional[list] = None) -> dict:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hz", type=float, default=50.0)
    ap.add_argument("--ticks", type=int, default=10_000)
    ap.add_argument("--k", type=int, default=10_240)
    ap.add_argument("--t", type=int, default=50)
    ap.add_argument("--json-out", type=str, default=None)
    args = ap.parse_args(argv)
    out = run_realtime_e2e(hz=args.hz, ticks=args.ticks, K=args.k, T=args.t)
    line = json.dumps(out)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()


__all__ = ["run_realtime_e2e", "main"]
