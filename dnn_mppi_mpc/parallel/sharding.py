"""Multi-chip execution: sample-sharded MPPI and scenario batching over a Mesh.

The reference has no multi-device code at all (SURVEY §2.10) — these are the
scaling dimensions of the engine:

* **sample sharding** — the K rollout dimension is split across mesh devices
  with ``shard_map``; the only cross-device traffic per control tick is
  ρ = pmin(S), η = psum(Σexp) and the psum of the (T, dim_u) weighted-noise
  update — a few hundred bytes over NVLink.
* **scenario batching** — independent control problems (multi-robot / multi-goal
  data collection, train/bullet_mpc_differential_drive.py:119-157) are vmapped
  and sharded over a 'batch' mesh axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MPPIConfig, MPPIParams
from ..solvers.mppi import MPPIState, StageCost, TerminalCost, mppi_step


def make_mesh(
    axis_names: Sequence[str] = ("k",), shape: Optional[Sequence[int]] = None
) -> Mesh:
    """Build a Mesh over all local devices; default: 1-D sample axis."""
    devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    import numpy as np

    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def make_sharded_mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    mesh: Mesh,
    axis: str = "k",
    rollout_fn: Optional[Callable] = None,
) -> Callable:
    """jit(shard_map(mppi_step)) with K sharded over ``axis``.

    Controller state / params / x0 are replicated; injected noise (if any) is
    sharded on its K axis. cfg.num_samples must divide evenly by the axis size.
    ``rollout_fn`` (e.g. ``MPPISolver(...).rollout_fn``, the GPU kernel)
    rolls out each device's shard; None keeps the scan path.
    """
    n = mesh.shape[axis]
    if cfg.num_samples % n != 0:
        raise ValueError(
            f"num_samples={cfg.num_samples} must be divisible by mesh axis {axis}={n}"
        )

    inner = functools.partial(
        mppi_step,
        cfg,
        dynamics_step,
        stage_cost,
        terminal_cost,
        axis_name=axis,
        rollout_fn=rollout_fn,
    )

    from ..solvers.mppi import MPPIAux

    aux_specs = MPPIAux(
        costs=P(axis),
        weights=P(axis),
        optimal_traj=P(),
        waypoint_idx=P(),
        status=P(),
    )
    # check_vma=False: inputs mix replicated pytrees (params/state/x0) with
    # the K-sharded noise; mppi_step's outputs become replicated only through
    # pmin/psum, which the varying-axis checker cannot always prove through
    # the filter/shift epilogue. Divisibility is validated above, and parity
    # vs the single-device step is asserted in tests/test_sharding.py.
    sharded = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis)),
        out_specs=(P(), P(), aux_specs),
        check_vma=False,
    )

    @jax.jit
    def step(params: MPPIParams, state: MPPIState, x0: jnp.ndarray, noise=None):
        if noise is None:
            # shard_map needs a concrete operand; sample per-shard inside by
            # passing a zero-size marker is messy — instead pre-sample sharded
            # noise outside via the carried key. Simplest robust path: draw the
            # full (K, T, nu) noise here; XLA shards the generation.
            from ..ops.sampling import sample_noise

            key = jax.random.fold_in(state.key, 1)
            noise = sample_noise(key, params.sigma, cfg.num_samples, cfg.horizon)
            noise = jax.lax.with_sharding_constraint(
                noise, NamedSharding(mesh, P(axis))
            )
        return sharded(params, state, x0, noise)

    return step


def make_batched_mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    mesh: Mesh,
    axis: str = "batch",
) -> Callable:
    """vmapped MPPI over a scenario batch, sharded over ``axis``.

    Each scenario has its own params/state/x0 (leading batch dim); sampling
    uses each scenario's carried key. Used for fleet-scale data collection
    (in place of running many train/bullet_* collection loops).
    """
    inner = functools.partial(mppi_step, cfg, dynamics_step, stage_cost, terminal_cost)
    batched = jax.vmap(lambda p, s, x: inner(p, s, x, None))
    spec = NamedSharding(mesh, P(axis))

    @jax.jit
    def step(params: MPPIParams, states: MPPIState, x0s: jnp.ndarray):
        x0s = jax.lax.with_sharding_constraint(x0s, spec)
        return batched(params, states, x0s)

    return step


def make_sharded_nmpc_fleet(solver, mesh: Mesh, axis: str = "batch") -> Callable:
    """Fleet of independent NMPC problems sharded over a mesh axis.

    The fleet (multi-robot / multi-scenario) dimension has NO cross-problem
    reductions — each device runs its B/n slice of the batched Riccati
    program, zero collectives (SURVEY §2.10(c) across devices). Built on
    ``shard_map`` (per-device program, not GSPMD auto-partitioning), so a
    solver with ``qp_backend="pallas"`` keeps the **QP kernel** on every
    device: each shard's fleet slice is one barrier-Riccati launch per tick
    (the custom_vmap rule of ops/pallas/riccati_qp.py dispatches inside the
    per-device trace). The XLA backend shards the same way. Fleet size must
    be a multiple of the axis size.
    """
    n = mesh.shape[axis]
    batched = jax.vmap(solver._core)
    spec = P(axis)
    # check_vma=False: OCPParams/NMPCAux pytrees carry every leaf with a
    # leading fleet dim here, but blanket P(axis) specs over whole pytrees
    # trip shard_map's varying-axis validation on jax 0.9 for the aux pytree
    # (solver status scalars); divisibility is validated explicitly below
    # instead, so a mis-sized fleet fails with a clear error rather than a
    # cryptic shard_map trace (round-2 advisor findings).
    sharded = jax.shard_map(
        batched,
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def step(params, states, x0s):
        B = jax.tree.leaves(x0s)[0].shape[0]
        if B % n != 0:
            raise ValueError(
                f"fleet size {B} must be divisible by mesh axis {axis!r}={n} "
                "(shard_map partitions the fleet dimension evenly)"
            )
        return jitted(params, states, x0s)

    return step


def make_sharded_mppi_fleet(
    cfg: MPPIConfig,
    dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    mesh: Mesh,
    axis: str = "batch",
    rollout_fn: Optional[Callable] = None,
) -> Callable:
    """Fleet of independent MPPI controllers sharded over a mesh axis.

    The MPPI analog of :func:`make_sharded_nmpc_fleet` (SURVEY §2.10(b)
    scenario parallelism across devices — the multi-robot collection fleets
    of train/bullet_mpc_differential_drive.py:119-157): the fleet dimension
    has no cross-member reductions, so each device runs its B/n slice with
    zero collectives — the vmapped ``mppi_step``, whose ``rollout_fn`` (the
    GPU kernel, or None for the scan) becomes one launch per device slice.

    Returns ``step(params, states, x0s) -> (u0s, states, auxs)``: shared
    ``params`` (replicated to every device), optionally carrying a leading
    member axis on ``ref_path``/``obstacles``/``obstacle_velocities`` (those
    leaves are then sharded with the fleet); batched ``states`` and ``x0s``.
    Fleet size must be a multiple of the mesh axis size.
    """
    n = mesh.shape[axis]
    core = functools.partial(
        mppi_step, cfg, dynamics_step, stage_cost, terminal_cost,
        rollout_fn=rollout_fn,
    )
    inner = jax.vmap(lambda p, s, x: core(p, s, x, None), in_axes=(0, 0, 0))

    spec = P(axis)
    jitted_cache: dict = {}

    def step(params: MPPIParams, states: MPPIState, x0s: jnp.ndarray):
        B = x0s.shape[0]
        if B % n != 0:
            raise ValueError(
                f"fleet size {B} must be divisible by mesh axis {axis!r}={n} "
                "(shard_map partitions the fleet dimension evenly)"
            )
        # Per-member leaves (leading fleet axis) shard with the fleet; shared
        # leaves replicate. Detected from ranks: ref_path (P, d) vs (B, P, d),
        # obstacles/velocities (n, 3) vs (B, n, 3).
        member_leaves = tuple(
            name
            for name, a in (
                ("ref_path", params.ref_path),
                ("obstacles", params.obstacles),
                ("obstacle_velocities", params.obstacle_velocities),
            )
            if a is not None and a.ndim == 3
        )
        # key must include the pytree STRUCTURE: a params whose optional
        # leaves appear/disappear (obstacles None → shared 2-D array) maps to
        # the same member_leaves but needs different shard_map in_specs
        cache_key = (member_leaves, jax.tree.structure(params))
        if cache_key not in jitted_cache:
            pspec = dataclasses.replace(
                jax.tree.map(lambda _: P(), params),
                **{name: spec for name in member_leaves},
            )

            # the vmapped core wants per-member params: broadcast shared
            # leaves to the local slice inside the shard
            def fn(p, s, x, _member=member_leaves):
                b = x.shape[0]
                p_local = jax.tree.map(
                    lambda a: jnp.broadcast_to(a, (b,) + a.shape), p
                )
                p_local = dataclasses.replace(
                    p_local, **{name: getattr(p, name) for name in _member}
                )
                return inner(p_local, s, x)

            jitted_cache[cache_key] = jax.jit(
                jax.shard_map(
                    fn,
                    mesh=mesh,
                    in_specs=(pspec, spec, spec),
                    out_specs=spec,
                    # same rationale as make_sharded_nmpc_fleet: blanket
                    # P(axis) over the aux pytree trips varying-axis
                    # validation on jax 0.9; divisibility checked above
                    check_vma=False,
                )
            )
        return jitted_cache[cache_key](params, states, x0s)

    return step


__all__ = [
    "make_mesh",
    "make_sharded_mppi_step",
    "make_batched_mppi_step",
    "make_sharded_nmpc_fleet",
    "make_sharded_mppi_fleet",
]
