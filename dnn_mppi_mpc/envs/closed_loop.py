"""Jitted closed-loop simulation and residual-dynamics data collection.

The reference closes control loops in Python — matplotlib FuncAnimation
callbacks (controllers/mppi_differential_drive.py:305-369) or PyBullet step
loops (simulation/bullet_differential_drive_dnn.py:419-467) — at one
controller call per Python frame. Here the whole loop (controller tick → plant
step → log) is a single ``lax.scan``, so an entire episode runs on-device, and
``vmap`` turns it into fleet-scale scenario batching (the one-program form of
the randomized data-collection series at train/bullet_mpc_differential_drive.py:119-157).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

# controller: (ctrl_state, x) -> (u, new_ctrl_state)
Controller = Callable[[object, jnp.ndarray], Tuple[jnp.ndarray, object]]
# plant transition: (x, u) -> x_next
PlantStep = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


class Episode(NamedTuple):
    states: jnp.ndarray  # (T+1, nx) visited plant states
    controls: jnp.ndarray  # (T, nu) applied controls
    errors: jnp.ndarray  # (T, nx) residual or tracking errors


def run_closed_loop(
    controller: Controller,
    plant_step: PlantStep,
    ctrl_state0,
    x0: jnp.ndarray,
    num_ticks: int,
    nominal_step: Optional[PlantStep] = None,
    x_ref: Optional[jnp.ndarray] = None,
    metric_fn: Optional[Callable[[jnp.ndarray, jnp.ndarray], dict]] = None,
    metric_cb: Optional[Callable[..., None]] = None,
    metric_every: int = 1,
) -> Tuple[Episode, object]:
    """Run ``num_ticks`` of controller+plant inside one ``lax.scan``.

    errors column:
    * with ``nominal_step``: residual x_next − F_nominal(x, u) — the
      model-error target of the DNN training pipeline
      (train/bullet_mpc_differential_drive.py:96, error = state − nominal)
    * with ``x_ref``: tracking error x − x_ref (collect_data_series :169)
    * else zeros.

    Metrics streaming (SURVEY §5.5 — the reference has only end-of-run
    artifacts): when both ``metric_fn`` (in-graph ``(x_next, u) → dict of
    scalars``) and ``metric_cb`` (host callable ``(tick, **metrics)``, e.g.
    ``utils.logging.MetricsWriter.write``) are given, every ``metric_every``-th
    tick streams its metrics out of the running scan via
    ``jax.debug.callback`` — live telemetry from a loop that never returns to
    Python. Callbacks are unordered (they don't stall the device); the tick
    index is passed so the host can re-order.
    """

    def tick(carry, t):
        cs, x = carry
        u, cs = controller(cs, x)
        x_next = plant_step(x, u)
        if nominal_step is not None:
            err = x_next - nominal_step(x, u)
        elif x_ref is not None:
            err = x - x_ref
        else:
            err = jnp.zeros_like(x)
        if metric_fn is not None and metric_cb is not None:
            metrics = metric_fn(x_next, u)
            jax.lax.cond(
                t % metric_every == 0,
                lambda m: jax.debug.callback(
                    lambda tt, mm: metric_cb(int(tt), **mm), t, m
                ),
                lambda m: None,
                metrics,
            )
        return (cs, x_next), (x_next, u, err)

    (ctrl_state, _), (xs, us, errs) = jax.lax.scan(
        tick, (ctrl_state0, x0), jnp.arange(num_ticks)
    )
    states = jnp.concatenate([x0[None], xs], axis=0)
    return Episode(states=states, controls=us, errors=errs), ctrl_state


def collect_residual_dataset(
    controller_factory: Callable[[jax.Array], Tuple[Controller, object]],
    plant_step: PlantStep,
    nominal_step: PlantStep,
    x0_sampler: Callable[[jax.Array], jnp.ndarray],
    key: jax.Array,
    num_series: int,
    ticks_per_series: int,
) -> Episode:
    """Batched randomized-scenario data collection.

    The one-program equivalent of looping `collect_data_series` scenarios in
    PyBullet: ``num_series`` independent closed loops run as one vmapped scan;
    results are flattened to the reference's (states, controls, errors) triplet
    layout (train/bullet_mpc_differential_drive.py:334-336).
    """
    keys = jax.random.split(key, num_series)

    def one(k):
        k1, k2 = jax.random.split(k)
        controller, cs0 = controller_factory(k1)
        x0 = x0_sampler(k2)
        ep, _ = run_closed_loop(
            controller, plant_step, cs0, x0, ticks_per_series, nominal_step=nominal_step
        )
        return ep

    eps = jax.vmap(one)(keys)
    # flatten (B, T, ·) → (B·T, ·); states drop the duplicated initial rows
    return Episode(
        states=eps.states[:, :-1].reshape(-1, eps.states.shape[-1]),
        controls=eps.controls.reshape(-1, eps.controls.shape[-1]),
        errors=eps.errors.reshape(-1, eps.errors.shape[-1]),
    )


def collect_residual_dataset_resumable(
    controller_factory: Callable[[jax.Array], Tuple[Controller, object]],
    plant_step: PlantStep,
    nominal_step: PlantStep,
    x0_sampler: Callable[[jax.Array], jnp.ndarray],
    key: jax.Array,
    num_series: int,
    ticks_per_series: int,
    out_dir: str,
    series_per_chunk: int = 8,
    config_tag: str = "",
) -> Episode:
    """Checkpointed data collection: episode-chunk-level resume (SURVEY §5.4).

    The reference's collection runs (train/bullet_mpc_differential_drive.py)
    lose everything on a crash — the .npy triplet is written once at the end
    (:334-336). Here the scenario series are collected in chunks of
    ``series_per_chunk``; each finished chunk is persisted to
    ``out_dir/chunk_<i>.npz``, and a re-run with the same key/out_dir skips
    completed chunks. Chunk keys are ``fold_in(key, chunk_idx)`` so a resumed
    run produces bit-identical data to an uninterrupted one.

    Cached chunks are validated against the chunk's PRNG key bits and
    ``config_tag`` (pass a fingerprint of the controller/sampler setup if you
    reuse ``out_dir`` across configurations) — a re-run with a different key
    or tag recomputes instead of silently returning stale data.
    """
    import os

    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    n_chunks = -(-num_series // series_per_chunk)
    parts = []
    for i in range(n_chunks):
        path = os.path.join(out_dir, f"chunk_{i:05d}.npz")
        n_i = min(series_per_chunk, num_series - i * series_per_chunk)
        chunk_key = jax.random.fold_in(key, i)
        key_bits = np.asarray(jax.random.key_data(chunk_key), np.uint32)
        if os.path.exists(path):
            with np.load(path) as z:
                valid = (
                    int(z["num_series"]) == n_i
                    and int(z["ticks"]) == ticks_per_series
                    and "key_bits" in z
                    and z["key_bits"].shape == key_bits.shape
                    and bool(np.all(z["key_bits"] == key_bits))
                    and (str(z["config_tag"]) if "config_tag" in z else "")
                    == config_tag
                )
                if valid:
                    parts.append(
                        Episode(
                            states=jnp.asarray(z["states"]),
                            controls=jnp.asarray(z["controls"]),
                            errors=jnp.asarray(z["errors"]),
                        )
                    )
                    continue  # valid checkpoint — skip recompute
        ep = collect_residual_dataset(
            controller_factory,
            plant_step,
            nominal_step,
            x0_sampler,
            chunk_key,
            n_i,
            ticks_per_series,
        )
        tmp = path + ".tmp.npz"
        np.savez(
            tmp,
            states=np.asarray(ep.states),
            controls=np.asarray(ep.controls),
            errors=np.asarray(ep.errors),
            num_series=n_i,
            ticks=ticks_per_series,
            key_bits=key_bits,
            config_tag=np.str_(config_tag),
        )
        os.replace(tmp, path)  # atomic: a crash mid-write never corrupts
        parts.append(ep)
    return Episode(
        states=jnp.concatenate([p.states for p in parts]),
        controls=jnp.concatenate([p.controls for p in parts]),
        errors=jnp.concatenate([p.errors for p in parts]),
    )


def mppi_controller(solver, params) -> Controller:
    """Adapt an MPPISolver into the (ctrl_state, x) -> (u, ctrl_state) shape
    run_closed_loop expects, so whole MPPI episodes run as one on-device scan
    (zero per-tick host dispatch).

    If you jit a function around the returned controller, call this factory
    INSIDE the traced function with params as a jit argument
    (``jit(lambda p, cs, x: run_closed_loop(mppi_controller(solver, p), …))``)
    — binding concrete device arrays here and capturing the closure in a jit
    bakes them into the program as constants, one compile per params."""

    step = solver._step  # jitted partial of solvers.mppi.mppi_step

    def controller(cs, x):
        u0, cs, _ = step(params, cs, x, None)
        return u0, cs

    return controller


def nmpc_controller(solver, params) -> Controller:
    """Adapt an NMPCSolver likewise (ctrl_state = NMPCState warm start)."""

    def controller(cs, x):
        u0, cs, _ = solver._solve(params, cs, x)
        return u0, cs

    return controller


class RecoveryState(NamedTuple):
    """Carry of :func:`with_recovery`: inner controller state + failure count."""

    inner: object
    bad_ticks: jnp.ndarray  # int32 consecutive failed solves
    resets: jnp.ndarray  # int32 total recoveries (telemetry)


def with_recovery(
    controller_aux: Callable,
    reset_fn: Callable,
    max_bad_ticks: int = 5,
    u_safe: Optional[jnp.ndarray] = None,
) -> Controller:
    """Elastic-recovery wrapper: reset a wedged controller in-scan.

    Both solvers already reject non-finite updates per tick, holding the
    previous sequence and flagging ``aux.status`` (warn-and-continue,
    SURVEY §5.3). A *persistently* failing solve — diverged warm start,
    NaN-poisoned nominal sequence — stays wedged under pure hold-previous.
    This wrapper adds the recovery tier the reference lacks entirely: after
    ``max_bad_ticks`` consecutive failed ticks it swaps in a fresh
    controller state from ``reset_fn(inner_state)`` (e.g. zeros the nominal
    sequence / warm start while keeping the PRNG key), optionally emitting
    ``u_safe`` (default: zero control) on failed ticks instead of the
    controller's output. Pure and scan-compatible — the whole
    detect→hold→reset ladder runs on-device.

    ``controller_aux(inner_state, x) -> (u, inner_state, aux)`` where
    ``aux.status`` bit 2 marks a failed solve (MPPIAux / NMPCAux convention).
    """

    def controller(rs: RecoveryState, x):
        u, inner, aux = controller_aux(rs.inner, x)
        failed = (aux.status & 2) > 0
        bad = jnp.where(failed, rs.bad_ticks + 1, 0).astype(jnp.int32)
        do_reset = bad >= max_bad_ticks
        inner = jax.tree.map(
            lambda fresh, cur: jnp.where(do_reset, fresh, cur),
            reset_fn(inner),
            inner,
        )
        safe = (
            jnp.zeros_like(u) if u_safe is None else jnp.broadcast_to(u_safe, u.shape)
        )
        u = jnp.where(failed, safe, u)
        return u, RecoveryState(
            inner=inner,
            bad_ticks=jnp.where(do_reset, 0, bad).astype(jnp.int32),
            resets=rs.resets + do_reset.astype(jnp.int32),
        )

    return controller


def recovery_init(inner_state) -> RecoveryState:
    return RecoveryState(
        inner=inner_state,
        bad_ticks=jnp.zeros((), jnp.int32),
        resets=jnp.zeros((), jnp.int32),
    )


__all__ = [
    "Episode",
    "run_closed_loop",
    "collect_residual_dataset",
    "collect_residual_dataset_resumable",
    "mppi_controller",
    "nmpc_controller",
    "RecoveryState",
    "with_recovery",
    "recovery_init",
]
