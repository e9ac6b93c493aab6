"""One-command scaling harness: solves/s at 1 device → all local devices → hosts.

Measures the sample-sharded MPPI (parallel/sharding.py) at increasing mesh
sizes and emits one efficiency JSON line per scale plus a summary — the
push-button measurement for the BASELINE scaling gate (≥80 % efficiency
from 1 card to all cards of a host, then to several hosts).

Weak-scaling protocol (fixed K/device): each scale runs
K = k_per_device × n_devices so per-device work is constant;
efficiency(n) = throughput(n) / (n × throughput(1)). The only cross-device
traffic per tick is the three softmax/weighted-noise reductions
(SURVEY §2.10), so efficiency should track collective latency, not
bandwidth. On a GPU each shard runs the rollout kernel.

Timing chains ticks on the device and waits for the chain
(utils/benchtime.py); every line names the platform it ran on.

Local rehearsal (virtual CPU mesh):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/scaling_run.py --k-per-device 256 --horizon 20

One GPU host: ``python examples/scaling_run.py``. Several hosts: run the
same command on every host with the coordinator's address:

    python examples/scaling_run.py --coordinator <host0>:8476 \
        --num-processes <P> --process-id <i>

Process 0 prints the results; scales are powers of two up to the global
device count.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from __graft_entry__ import _flagship
from dnn_mppi_mpc.models.tile import unicycle_tile
from dnn_mppi_mpc.parallel.distributed import initialize_distributed
from dnn_mppi_mpc.parallel.sharding import make_sharded_mppi_step
from dnn_mppi_mpc.solvers.mppi import MPPISolver, MPPIState
from dnn_mppi_mpc.utils.benchtime import chain_timing


def measure(step, params, state0, x0, n, reps):
    """Median per-tick seconds of an n-tick chain of a jitted sharded step."""

    def make_runner(n):
        def body(carry, _):
            state, x = carry
            u0, state, aux = step(params, state, x)
            # state-dependent chaining so ticks cannot be overlapped
            x = x.at[0].add(u0[0] * 1e-6)
            return (state, x), aux.costs.min()

        @jax.jit
        def chain(state, x):
            (_, _), ys = jax.lax.scan(body, (state, x), None, length=n)
            return ys

        return lambda: chain(state0, x0)

    return chain_timing(make_runner, n, reps).p50


def measure_collectives(mesh, local_K, horizon, n, reps):
    """Per-tick cost of JUST the sharded tick's cross-device exchanges.

    The sharded tick's only cross-device traffic is ρ = pmin(min S),
    η = psum(Σ exp) and one psum of a (T, nu) partial (SURVEY §2.10); this
    times that exact pattern on synthetic per-shard data so the scaling
    artifact separates collective latency from rollout compute.
    """
    axis = "k"
    spec_s = PartitionSpec(axis)

    def tick(S_local, carry):
        rho = jax.lax.pmin(jnp.min(S_local), axis)
        eta = jax.lax.psum(jnp.sum(jnp.exp(rho - S_local)), axis)
        weps = jax.lax.psum(
            jnp.full((horizon, 2), eta / local_K, S_local.dtype), axis
        )
        return S_local + carry * 1e-9 + weps[0, 0] * 1e-9

    inner = jax.shard_map(
        lambda S, c: tick(S, c), mesh=mesh,
        in_specs=(spec_s, PartitionSpec()), out_specs=spec_s,
    )

    n_dev = mesh.devices.size
    S0 = jax.device_put(
        jnp.linspace(0.0, 1.0, local_K * n_dev, dtype=jnp.float32),
        NamedSharding(mesh, spec_s),
    )

    def make_runner(n):
        def body(S, _):
            S = inner(S, S[0])
            return S, S[0]

        @jax.jit
        def chain(S):
            _, ys = jax.lax.scan(body, S, None, length=n)
            return jnp.sum(ys)

        return lambda: chain(S0)

    return chain_timing(make_runner, n, reps).p50


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k-per-device", type=int, default=1280)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--chain", type=int, default=100, help="ticks per timed chain")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--coordinator", type=str, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--out", type=str, default=None,
                    help="also write the summary JSON to this path "
                    "(process 0 only) — the checked-in scaling artifact")
    args = ap.parse_args()

    initialize_distributed(args.coordinator, args.num_processes, args.process_id)

    devices = jax.devices()
    n, reps = args.chain, args.reps

    # powers of two up to the global device count: 1, 2, 4, ...
    scales = []
    n = 1
    while n <= len(devices):
        scales.append(n)
        n *= 2
    if scales[-1] != len(devices):
        scales.append(len(devices))

    # Multi-process: every process must own a slice of each mesh (a mesh of
    # only process-0 devices leaves the other controllers without addressable
    # shards), so sweep only multiples of process_count and take n/P devices
    # from every process.
    n_proc = jax.process_count()
    if n_proc > 1:
        scales = [s for s in scales if s % n_proc == 0]
        by_proc: dict = {}
        for d in devices:
            by_proc.setdefault(d.process_index, []).append(d)

        def pick(n_dev):
            per = n_dev // n_proc
            sel = []
            for p in sorted(by_proc):
                sel.extend(by_proc[p][:per])
            return sel
    else:
        pick = lambda n_dev: devices[:n_dev]

    results = []
    taus = []
    for n_dev in scales:
        K = args.k_per_device * n_dev
        cfg, params, step_fn, stage, terminal = _flagship(K, args.horizon)
        mesh = Mesh(np.asarray(pick(n_dev)), ("k",))
        rollout_fn = MPPISolver(
            cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(cfg.dt)
        ).rollout_fn
        step = make_sharded_mppi_step(
            cfg, step_fn, stage, terminal, mesh, rollout_fn=rollout_fn
        )
        # Commit the replicated inputs to the mesh so every process's jit
        # sees the same device assignment up front.
        rep = NamedSharding(mesh, PartitionSpec())
        state0 = jax.device_put(MPPIState.init(cfg), rep)
        x0 = jax.device_put(jnp.zeros(3, jnp.float32), rep)
        params = jax.device_put(params, rep)
        tau = measure(step, params, state0, x0, n, reps)
        tau_coll = measure_collectives(mesh, args.k_per_device, args.horizon, n, reps)
        taus.append(tau)
        results.append({"devices": n_dev, "K": K, "per_solve_ms": tau * 1e3,
                        "solves_per_s": 1 / tau,
                        "collective_per_tick_ms": tau_coll * 1e3})
        if jax.process_index() == 0:
            print(json.dumps(results[-1]), flush=True)

    if jax.process_index() == 0:
        base = taus[0]
        summary = {
            "metric": "mppi_weak_scaling_efficiency",
            "k_per_device": args.k_per_device,
            "horizon": args.horizon,
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "n_hosts": jax.process_count(),
            "scales": results,
            # weak scaling: constant work/device → efficiency = t(1)/t(n)
            "efficiency": {str(r["devices"]): round(base / t, 3)
                           for r, t in zip(results, taus)},
        }
        print(json.dumps(summary))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
