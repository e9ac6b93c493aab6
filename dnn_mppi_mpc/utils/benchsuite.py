"""``python bench.py --suite``: every benchmark row measured in one process.

Each row chains the full control tick on the device (``lax.scan`` over the
solver step + plant step; utils/benchtime.py) and reports per-tick times and
solves/s on the GPU. The suite refuses to run anywhere else: a CPU number is
not a measurement of this program. ``compare=True`` (``--compare``) times
each row that has a GPU kernel twice, on the kernel and on the plain XLA
path, in the order kernel, XLA, XLA, kernel.

===================  ====================================================
``flagship``         diff-drive MPPI K=10 240 T=50 W=20
``pod_k``            diff-drive MPPI K=102 400 T=50
``racecar``          bicycle MPPI K=10 240 T=20 W=200 + polygon collision
``goal_seeking``     pytorch_mppi spec: soft cost, moving obstacles, SavGol
``mppi_fleet``       B=16 vmapped MPPI fleet, K=1 024 T=50 each
``dnn_mppi``         MLP-residual MPPI K=1 024 T=25 (scan path)
``nmpc_rti``         diff-drive NMPC RTI N=30, 2 obstacle rows
``nmpc_fleet``       B=128 N=30 NMPC fleet
``sharded_tick``     sample-sharded flagship over every local device
``sharded_mppi_fleet``  mesh-sharded MPPI fleet, 16 members per device
===================  ====================================================
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .benchtime import chain_timing, scan_chain_runner
from .platform import require_gpu

ROWS = (
    "flagship",
    "pod_k",
    "racecar",
    "goal_seeking",
    "mppi_fleet",
    "dnn_mppi",
    "nmpc_rti",
    "nmpc_fleet",
    "sharded_tick",
    "sharded_mppi_fleet",
)
# rows whose default GPU path runs a kernel (the others run XLA only)
KERNEL_ROWS = tuple(r for r in ROWS if r != "dnn_mppi")


@dataclasses.dataclass
class Workload:
    name: str
    make_runner: Callable[[int], Callable[[], object]]
    n: int  # ticks per timed chain
    solves_per_tick: int  # fleet rows: members per tick; else 1
    meta: Dict


def _mppi_workload(name, solver, params, x0, n, meta) -> Workload:
    """Single-controller MPPI chain: solver step + plant step per tick."""
    st0 = solver.init()
    core, step_fn = solver._step, solver.dynamics_step

    def body(params, state, x):
        u0, state, aux = core(params, state, x, None)
        return (state, step_fn(x, u0)), aux.costs[0]

    meta = dict(meta, path="kernel" if solver.rollout_fn is not None else "xla_scan")
    return Workload(
        name, lambda n: scan_chain_runner(body, params, st0, x0, n), n, 1, meta
    )


def _use_pallas(kernel: bool) -> Optional[bool]:
    return None if kernel else False


def _build_flagship(kernel: bool, small: bool) -> Workload:
    from __graft_entry__ import _flagship

    from ..models.tile import unicycle_tile
    from ..solvers.mppi import MPPISolver

    K, T = (256, 8) if small else (10_240, 50)
    cfg, params, step_fn, stage, terminal = _flagship(K, T)
    solver = MPPISolver(
        cfg, step_fn, stage, terminal, use_pallas=_use_pallas(kernel),
        tile_dynamics=unicycle_tile(cfg.dt),
    )
    return _mppi_workload(
        "flagship", solver, params, jnp.zeros(3, jnp.float32), 200, {"K": K, "T": T}
    )


def _build_pod_k(kernel: bool, small: bool) -> Workload:
    from __graft_entry__ import _flagship

    from ..models.tile import unicycle_tile
    from ..solvers.mppi import MPPISolver

    K, T = (512, 8) if small else (102_400, 50)
    cfg, params, step_fn, stage, terminal = _flagship(K, T)
    solver = MPPISolver(
        cfg, step_fn, stage, terminal, use_pallas=_use_pallas(kernel),
        tile_dynamics=unicycle_tile(cfg.dt),
    )
    return _mppi_workload(
        "pod_k", solver, params, jnp.zeros(3, jnp.float32), 50, {"K": K, "T": T}
    )


def _build_racecar(kernel: bool, small: bool) -> Workload:
    from .. import presets
    from ..paths.generators import lemniscate_with_speed

    K, T = (128, 6) if small else (10_240, 20)
    ref = lemniscate_with_speed(10.0, 200, speed=5.0)
    solver, params = presets.racecar_mppi(
        ref,
        num_samples=K,
        horizon=T,
        obstacles=jnp.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]]),
        use_pallas=_use_pallas(kernel),
    )
    x0 = ref[0].astype(jnp.float32)
    return _mppi_workload(
        "racecar", solver, params, x0, 100, {"K": K, "T": T, "W": 200, "n_obs": 2}
    )


def _build_goal_seeking(kernel: bool, small: bool) -> Workload:
    from .. import presets

    K = 128 if small else 1536
    solver, params = presets.goal_seeking_mppi(
        jnp.array([6.0, 6.0, 1.57]),
        num_samples=K,
        horizon=10 if small else 50,
        obstacles=jnp.array([[5.0, 4.0, 0.5], [3.5, 3.5, 0.5], [2.0, 5.0, 0.5]]),
        obstacle_velocities=0.09 * jnp.array([[0.2, 0.1], [-0.1, 0.1], [0.1, -0.2]]),
        use_pallas=_use_pallas(kernel),
    )
    return _mppi_workload(
        "goal_seeking", solver, params, jnp.zeros(3, jnp.float32), 200,
        {"K": K, "T": solver.cfg.horizon, "n_obs": 3, "collision": "soft"},
    )


def _mlp_residual(widths, seed=0):
    """The residual regressor's layout (input Dense, tanh hidden Dense
    layers, output Dense — models/learned.MLP) in plain jnp with weights
    drawn from a seed: the benchmark needs the matrix products, not the
    training stack."""
    rng = np.random.default_rng(seed)
    layers = [
        (jnp.asarray(rng.normal(0.0, a**-0.5, (a, b)), jnp.float32), jnp.zeros(b, jnp.float32))
        for a, b in zip(widths[:-1], widths[1:])
    ]

    def residual(feats):
        x = feats @ layers[0][0] + layers[0][1]
        for W, b in layers[1:-1]:
            x = jnp.tanh(x @ W + b)
        W, b = layers[-1]
        return 0.01 * (x @ W + b)

    return residual


def _build_dnn_mppi(kernel: bool, small: bool) -> Workload:
    from .. import presets
    from ..paths.generators import line

    K = 128 if small else 1024
    learned = _mlp_residual((5, 128, 128, 3))  # examples/dnn_mppi.py default widths
    ref = line(jnp.zeros(2), jnp.array([4.0, 4.0]), num_points=100)
    solver, params = presets.dnn_mppi(ref, learned, num_samples=K, horizon=25)
    return _mppi_workload(
        "dnn_mppi", solver, params, jnp.zeros(3, jnp.float32), 100,
        {"K": K, "T": 25, "net": "mlp_5_128_128_3"},
    )


def _fleet_params(B: int, K: int, T: int):
    """B diff-drive controllers, each with its own straight path."""
    from ..config import MPPIConfig, MPPIParams
    from ..paths.generators import line

    cfg = MPPIConfig(
        num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=0.05, waypoint_search_len=20,
    )
    rng = np.random.default_rng(0)
    goals = rng.uniform(-4, 4, (B, 2)).astype(np.float32)
    paths = jnp.stack([line(jnp.zeros(2), jnp.asarray(g), num_points=80) for g in goals])
    params = MPPIParams(
        sigma=jnp.array([[0.2, 0.0], [0.0, 0.1]], jnp.float32),
        stage_weight=jnp.array([8.0, 8.0, 2.0], jnp.float32),
        terminal_weight=jnp.array([8.0, 8.0, 2.0], jnp.float32),
        u_min=jnp.array([-3.0, -3.14], jnp.float32),
        u_max=jnp.array([3.0, 3.14], jnp.float32),
        ref_path=paths,  # (B, P, 3) per-member references
    )
    return cfg, params


def _fleet_solver(cfg, kernel: bool):
    from ..models.dynamics import unicycle
    from ..models.integrators import euler_step
    from ..models.tile import unicycle_tile
    from ..solvers.mppi import MPPISolver, make_tracking_costs

    step_fn = lambda x, u: euler_step(unicycle, x, u, cfg.dt)
    return MPPISolver(
        cfg, step_fn, *make_tracking_costs(cfg), use_pallas=_use_pallas(kernel),
        tile_dynamics=unicycle_tile(cfg.dt),
    )


def _fleet_workload(name, fleet, solver, params, B, n, meta) -> Workload:
    from ..solvers.mppi import MPPIState

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    st0 = jax.vmap(lambda k: MPPIState.init(solver.cfg, k))(keys)
    x0 = jnp.zeros((B, 3), jnp.float32)
    plant = jax.vmap(solver.dynamics_step)

    def body(params, st, x):
        u0s, st, auxs = fleet(params, st, x)
        return (st, plant(x, u0s)), auxs.costs[:, 0]

    meta = dict(meta, path="kernel" if solver.rollout_fn is not None else "xla_scan")
    return Workload(
        name, lambda n: scan_chain_runner(body, params, st0, x0, n), n, B, meta
    )


def _build_mppi_fleet(kernel: bool, small: bool) -> Workload:
    B, K, T = (4, 128, 8) if small else (16, 1024, 50)
    cfg, params = _fleet_params(B, K, T)
    solver = _fleet_solver(cfg, kernel)

    def fleet(p, states, xs):
        def member(path, st, x):
            return solver._step(dataclasses.replace(p, ref_path=path), st, x, None)

        return jax.vmap(member)(p.ref_path, states, xs)

    return _fleet_workload("mppi_fleet", fleet, solver, params, B, 100, {"B": B, "K": K, "T": T})


def _nmpc_chain_workload(name, solver, params, st0, x0, n, solves_per_tick, meta, fleet):
    core = jax.vmap(solver._core) if fleet else solver._core
    plant = jax.vmap(solver.dyn_step) if fleet else solver.dyn_step

    def body(params, st, x):
        u0, st, _ = core(params, st, x)
        return (st, plant(x, u0)), (u0[0, 0] if fleet else u0[0])

    meta = dict(meta, qp_backend=solver.cfg.qp_backend)
    return Workload(
        name, lambda n: scan_chain_runner(body, params, st0, x0, n), n,
        solves_per_tick, meta,
    )


def _qp_backend(kernel: bool) -> Optional[str]:
    return None if kernel else "xla"


def _build_nmpc_rti(kernel: bool, small: bool) -> Workload:
    from .. import presets

    N = 8 if small else 30
    obstacles = jnp.array([[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]])
    solver, params = presets.diff_drive_nmpc(
        jnp.array([3.0, 2.0, 0.0]), N=N, obstacles=obstacles,
        sqp_iters=1, qp_backend=_qp_backend(kernel),
    )
    x0 = jnp.zeros(3, jnp.float32)
    return _nmpc_chain_workload(
        "nmpc_rti", solver, params, solver.init(x0), x0, 50, 1,
        {"N": N, "n_obs": 2, "sqp_iters": 1}, fleet=False,
    )


def _build_nmpc_fleet(kernel: bool, small: bool) -> Workload:
    from .. import presets
    from ..solvers.sqp import NMPCState

    B, N = (4, 8) if small else (128, 30)
    # preset defaults (sqp_iters=2), per-member goals and obstacles
    solver, base_params = presets.diff_drive_nmpc(
        jnp.zeros(3, jnp.float32), N=N,
        obstacles=jnp.array([[1.0, 0.0, 0.3]], jnp.float32),
        qp_backend=_qp_backend(kernel),
    )
    rng = np.random.default_rng(0)
    ang = rng.uniform(0, 2 * np.pi, B)
    goals = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang), ang], axis=1)
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 3)), jnp.float32)
    obs = np.concatenate([0.55 * goals[:, :2], np.full((B, 1), 0.25)], axis=1)[:, None, :]

    def member_params(goal, ob):
        yref = jnp.concatenate([goal, jnp.zeros(2, jnp.float32)])
        return dataclasses.replace(
            base_params, yref=jnp.broadcast_to(yref, (N, 5)), yref_e=goal, p=ob
        )

    params = jax.vmap(member_params)(
        jnp.asarray(goals, jnp.float32), jnp.asarray(obs, jnp.float32)
    )
    st0 = jax.vmap(lambda x: NMPCState.init(solver.cfg, x))(x0s)
    return _nmpc_chain_workload(
        "nmpc_fleet", solver, params, st0, x0s, 20, B, {"B": B, "N": N}, fleet=True,
    )


def _build_sharded_tick(kernel: bool, small: bool) -> Workload:
    """Sample-sharded flagship tick over every local device (on one card:
    the shard_map wrapper and the collectives at mesh size 1)."""
    from __graft_entry__ import _flagship

    from jax.sharding import NamedSharding, PartitionSpec

    from ..models.tile import unicycle_tile
    from ..parallel.sharding import make_mesh, make_sharded_mppi_step
    from ..solvers.mppi import MPPISolver, MPPIState

    n_dev = len(jax.devices())
    K, T = ((128, 8) if small else (10_240, 50))
    K *= n_dev
    cfg, params, step_fn, stage, terminal = _flagship(K, T)
    rollout_fn = MPPISolver(
        cfg, step_fn, stage, terminal, use_pallas=_use_pallas(kernel),
        tile_dynamics=unicycle_tile(cfg.dt),
    ).rollout_fn
    mesh = make_mesh(("k",))
    step = make_sharded_mppi_step(cfg, step_fn, stage, terminal, mesh, rollout_fn=rollout_fn)

    rep = NamedSharding(mesh, PartitionSpec())
    st0 = jax.device_put(MPPIState.init(cfg), rep)
    x0 = jax.device_put(jnp.zeros(3, jnp.float32), rep)
    params = jax.device_put(params, rep)

    def body(params, state, x):
        u0, state, aux = step(params, state, x)
        return (state, step_fn(x, u0)), aux.costs.min()

    return Workload(
        "sharded_tick", lambda n: scan_chain_runner(body, params, st0, x0, n), 200, 1,
        {"K": K, "T": T, "devices": n_dev,
         "path": "kernel" if rollout_fn is not None else "xla_scan"},
    )


def _build_sharded_mppi_fleet(kernel: bool, small: bool) -> Workload:
    """Mesh-sharded MPPI fleet (fleet axis partitioned, zero collectives)."""
    from ..parallel.sharding import make_mesh, make_sharded_mppi_fleet
    from ..solvers.mppi import make_tracking_costs

    n_dev = len(jax.devices())
    B, K, T = (n_dev, 128, 8) if small else (16 * n_dev, 1024, 50)
    cfg, params = _fleet_params(B, K, T)
    solver = _fleet_solver(cfg, kernel)
    fleet = make_sharded_mppi_fleet(
        cfg, solver.dynamics_step, *make_tracking_costs(cfg), make_mesh(("batch",)),
        axis="batch", rollout_fn=solver.rollout_fn,
    )
    return _fleet_workload(
        "sharded_mppi_fleet", fleet, solver, params, B, 100,
        {"B": B, "K": K, "T": T, "devices": n_dev},
    )


BUILDERS = {
    "flagship": _build_flagship,
    "pod_k": _build_pod_k,
    "racecar": _build_racecar,
    "goal_seeking": _build_goal_seeking,
    "mppi_fleet": _build_mppi_fleet,
    "dnn_mppi": _build_dnn_mppi,
    "nmpc_rti": _build_nmpc_rti,
    "nmpc_fleet": _build_nmpc_fleet,
    "sharded_tick": _build_sharded_tick,
    "sharded_mppi_fleet": _build_sharded_mppi_fleet,
}


def _row(w: Workload, per_tick) -> Dict:
    per_tick = sorted(per_tick)
    p50 = per_tick[len(per_tick) // 2]
    dev = jax.devices()[0]
    return {
        "workload": w.name,
        "per_tick_ms_best": per_tick[0] * 1e3,
        "per_tick_ms_p50": p50 * 1e3,
        "per_tick_ms_p99": per_tick[min(len(per_tick) - 1, int(0.99 * len(per_tick)))] * 1e3,
        "solves_per_s": w.solves_per_tick / p50,
        "ticks_per_chain": w.n,
        "chains": len(per_tick),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        **w.meta,
    }


def run_suite(
    rows: Optional[Tuple[str, ...]] = None,
    reps: int = 10,
    compare: bool = False,
) -> list:
    """Measure the selected rows on the GPU; print one JSON line per row and
    path; return the rows."""
    names = ROWS if rows is None else tuple(rows)
    unknown = [n for n in names if n not in BUILDERS]
    if unknown:
        raise ValueError(f"unknown suite rows {unknown}; available: {list(ROWS)}")
    require_gpu()

    results = []
    for name in names:
        paths = (True, False) if compare and name in KERNEL_ROWS else (True,)
        loads = {k: BUILDERS[name](k, False) for k in paths}
        runners = {k: loads[k].make_runner(loads[k].n) for k in paths}
        for k in paths:  # compile + warm up every path first
            jax.block_until_ready(runners[k]())
        per_tick = {k: [] for k in paths}
        order = paths + paths[::-1]  # kernel, XLA, XLA, kernel
        for k in order:
            per_tick[k] += chain_timing(
                lambda n, k=k: runners[k], loads[k].n, max(1, reps // 2)
            ).per_tick
        for k in paths:
            row = _row(loads[k], per_tick[k])
            results.append(row)
            print(json.dumps(row), flush=True)
    return results
