"""Real-time 50 Hz control loop: native pacer + jitted MPPI + telemetry ring.

The deployment shape of simulation/bullet_differential_drive_dnn.py:419-467
against a simulated plant, paced by the C++ absolute-deadline pacer and logged
through the lock-free telemetry ring (dnn_mppi_mpc/runtime).

    python examples/realtime_loop.py --hz 50 --ticks 250
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _flagship
from dnn_mppi_mpc.models import euler_step, unicycle, unicycle_tile
from dnn_mppi_mpc.runtime.loop import RealtimeLoop
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_tracking_costs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hz", type=float, default=50.0)
    ap.add_argument("--ticks", type=int, default=250)
    ap.add_argument("--samples", type=int, default=4096)
    args = ap.parse_args()

    cfg, params, step_fn, stage, terminal = _flagship(args.samples, 50)
    solver = MPPISolver(cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(cfg.dt))

    # controller closure carrying MPPI state between ticks
    holder = {"state": solver.init(), "params": params}

    def controller(x_np):
        u0, holder["state"], _ = solver.step(
            holder["params"], holder["state"], jnp.asarray(x_np, jnp.float32)
        )
        return np.asarray(u0)

    plant = {"x": np.zeros(3, np.float32)}
    plant_step = jax.jit(lambda x, u: euler_step(unicycle, x, u, cfg.dt))

    def read_state():
        return plant["x"]

    def apply_control(u):
        plant["x"] = np.asarray(
            plant_step(jnp.asarray(plant["x"]), jnp.asarray(u, jnp.float32))
        )

    loop = RealtimeLoop(controller, read_state, apply_control, hz=args.hz)
    stats = loop.run(args.ticks)
    tel = loop.drain_telemetry()
    solve_ms = np.sort(tel["solve_ns"]) / 1e6
    print(f"pacer: {stats}")
    print(
        f"solve p50 {solve_ms[len(solve_ms)//2]:.2f} ms  "
        f"p99 {solve_ms[int(len(solve_ms)*0.99)]:.2f} ms  "
        f"budget {1e3/args.hz:.1f} ms  overruns {stats['overruns']}"
    )
    print(f"final state: {np.round(plant['x'], 3)}")


if __name__ == "__main__":
    main()
