"""Batched information-theoretic MPPI engine (Williams et al.) — the product core.

One solver replaces all eight reference MPPI variants (numpy/torch/cupy,
diff-drive/race-car, with/without obstacles — SURVEY §2.1): the K·T scalar
Python loops of controllers/mppi_differential_drive.py:111-126 become a single
``lax.scan`` over the horizon whose carry holds all K rollout states, so every
step is one wide op over the sample dimension (or one GPU kernel for the
whole rollout, :func:`make_rollout_kernel`). The derivation being
implemented is the information-theoretic MPPI of notebook/mppi_note.ipynb.

Semantics preserved (with file:line provenance):
* exploration split: first ⌊(1−explore)·K⌋ samples perturb the nominal sequence,
  the rest are pure noise            — mppi_differential_drive.py:116-119
* in-rollout control clamp ``_g``     — mppi_differential_drive.py:285-289
  (the clamped value also enters the control-energy term, as the reference's
  in-place ``_g(v[k,t-1])`` mutation does)
* stage cost + γ·uᵀΣ⁻¹v               — mppi_differential_drive.py:124
* softmax weights with ρ=min S        — mppi_differential_drive.py:167-180 and
  the vectorized λ-convention at mppi_race_car_obstacle.py:216-226
* weighted-noise update over the *unclamped* ε, then smoothing filter
                                      — mppi_differential_drive.py:132-141
* receding-horizon shift              — mppi_differential_drive.py:162-163
* returned u0 is the updated, unclamped first control
                                      — mppi_differential_drive.py:165

The nearest-waypoint search is made pure: the window start is fixed per control
tick and carried in :class:`MPPIState` (the reference mutates it per cost call,
mppi_differential_drive.py:228 — an order-dependent quirk deliberately not
replicated; see SURVEY §7).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ..config import CostAccumulation, MPPIConfig, MPPIParams
from ..ops.costs import (
    COLLISION_PENALTY,
    TrackingSpec,
    circle_robot_collision,
    soft_obstacle_cost,
    vehicle_polygon_collision,
)
from ..ops.filters import apply_filter
from ..ops.sampling import sample_noise, sigma_inverse
from ..ops.waypoints import nearest_waypoint, nearest_waypoint_carried
from ..utils.platform import platform

_HIGHEST = jax.lax.Precision.HIGHEST


@register_pytree_node_class
@dataclasses.dataclass
class MPPIState:
    """Per-controller carry: nominal sequence, waypoint window start, PRNG key."""

    u_prev: jnp.ndarray  # (T, dim_u)
    waypoint_idx: jnp.ndarray  # scalar int32
    key: jax.Array

    def tree_flatten(self):
        return (self.u_prev, self.waypoint_idx, self.key), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def init(cls, cfg: MPPIConfig, key: Optional[jax.Array] = None) -> "MPPIState":
        return cls(
            u_prev=jnp.zeros((cfg.horizon, cfg.dim_u), dtype=jnp.float32),
            waypoint_idx=jnp.zeros((), dtype=jnp.int32),
            key=key if key is not None else jax.random.PRNGKey(0),
        )


class CostContext(NamedTuple):
    """Tick-level context threaded to stage/terminal cost functions."""

    params: MPPIParams
    waypoint_start: jnp.ndarray  # int32 window start for this control tick
    waypoint_ref: Optional[jnp.ndarray] = None  # precomputed nearest-waypoint
    # rows (..., d) — set by the rollout-carry scan body so the tracking cost
    # reuses the body's single lookup instead of repeating the gather+argmin


# stage_cost(x: (..., nx), t: int32, ctx) -> (...,); terminal likewise without t.
StageCost = Callable[[jnp.ndarray, jnp.ndarray, CostContext], jnp.ndarray]
TerminalCost = Callable[[jnp.ndarray, CostContext], jnp.ndarray]


class MPPIAux(NamedTuple):
    """Diagnostics returned by one MPPI step (cheap; no [K,T,nx] buffers)."""

    costs: jnp.ndarray  # (K,) sample costs S
    weights: jnp.ndarray  # (K,) softmax weights
    optimal_traj: jnp.ndarray  # (T, dim_x) rollout of the updated sequence
    waypoint_idx: jnp.ndarray  # int32 tick window start after update
    status: jnp.ndarray  # int32 bitmask: 1 = end of reference path reached
    # (mppi_differential_drive.py:97-100), 2 = non-finite detected (solve
    # rejected, previous sequence held — the warn-and-continue failure handling
    # of SURVEY §5.3)


def make_tracking_costs(
    cfg: MPPIConfig,
    *,
    wrap_yaw: bool = False,
    collision: str = "none",
    robot_radius: float = 0.5,
    vehicle_length: float = 4.0,
    vehicle_width: float = 3.0,
    safety_margin_rate: float = 1.5,
    soft_safety_distance: float = 2.0,
    soft_weight: float = 100.0,
) -> Tuple[StageCost, TerminalCost]:
    """Build the reference's waypoint-tracking stage/terminal costs.

    ``collision``:
      * 'none'    — plain tracking (mppi_differential_drive.py:222-249)
      * 'circle'  — +1e10-style penalty on circle-robot overlap
                    (mppi_differential_drive_obs.py:242,301-313)
      * 'polygon' — 9-point vehicle outline vs circles
                    (mppi_race_car_obstacle.py:157,255-274)
      * 'soft'    — exponential soft penalty (test_mppi_diff_obs.py:59-64)

    Both functions carry their constants as ``tracking_spec``
    (:class:`~dnn_mppi_mpc.ops.costs.TrackingSpec`), which is how the solver
    knows the rollout kernel can compute the same cost.
    """
    spec = TrackingSpec(
        wrap_yaw=wrap_yaw,
        collision=collision,
        robot_radius=robot_radius,
        vehicle_length=vehicle_length,
        vehicle_width=vehicle_width,
        safety_margin_rate=safety_margin_rate,
        soft_safety_distance=soft_safety_distance,
        soft_weight=soft_weight,
    )

    def tracking(x: jnp.ndarray, weight: jnp.ndarray, ctx: CostContext) -> jnp.ndarray:
        if ctx.waypoint_ref is not None:
            # rollout-carry scan body already did this lookup (one semantic
            # lookup per (k, t) — see mppi_step)
            ref = ctx.waypoint_ref
        elif ctx.waypoint_start.ndim > 0:
            # waypoint_carry="rollout": per-sample window starts carried by the
            # scan (ops/waypoints.nearest_waypoint_carried)
            _, ref = nearest_waypoint_carried(
                ctx.params.ref_path,
                x[..., :2],
                ctx.waypoint_start,
                cfg.waypoint_search_len,
            )
        else:
            _, ref = nearest_waypoint(
                ctx.params.ref_path,
                x[..., :2],
                ctx.waypoint_start,
                cfg.waypoint_search_len,
            )
        n = weight.shape[-1]
        err = x[..., :n] - ref[..., :n]
        if wrap_yaw:
            # yaw wrapped to [0, 2π) before differencing (mppi_race_car_obstacle.py:151)
            yaw = jnp.mod(x[..., 2] + 2.0 * jnp.pi, 2.0 * jnp.pi)
            err = err.at[..., 2].set(yaw - ref[..., 2])
        return jnp.sum(weight * err * err, axis=-1)

    def collision_cost(
        x: jnp.ndarray, ctx: CostContext, t: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        obs = ctx.params.obstacles
        if collision == "none" or obs is None:
            return jnp.zeros(x.shape[:-1], dtype=x.dtype)
        if ctx.params.obstacle_velocities is not None and t is not None:
            # obstacles drift during the rollout at their velocities, measured
            # from rollout start (test_mppi_diff_obs.py:17-20, :133-134 —
            # positions = initial + velocity·(t·dt); terminal uses initial).
            obs = obs.at[..., :2].add(
                ctx.params.obstacle_velocities[..., :2]
                * (t.astype(x.dtype) * cfg.dt)
            )
        if collision == "circle":
            # the reference's circle test inflates the ROBOT radius by the
            # safety margin (mppi_differential_drive_obs.py:303-305) — a
            # round-4 strict crosscheck against that class caught this
            # factor missing here (tests/test_reference_crosscheck.py)
            return (
                circle_robot_collision(
                    x[..., :2], obs, robot_radius * safety_margin_rate
                )
                * COLLISION_PENALTY
            )
        if collision == "polygon":
            return (
                vehicle_polygon_collision(
                    x, obs, vehicle_length, vehicle_width, safety_margin_rate
                )
                * COLLISION_PENALTY
            )
        return soft_obstacle_cost(x[..., :2], obs, soft_safety_distance, soft_weight)

    def stage(x, t, ctx):
        return tracking(x, ctx.params.stage_weight, ctx) + collision_cost(x, ctx, t)

    def terminal(x, ctx):
        return tracking(x, ctx.params.terminal_weight, ctx) + collision_cost(x, ctx)

    stage.tracking_spec = terminal.tracking_spec = spec
    return stage, terminal


def unify_float_dtype(tree, dtype):
    """Cast floating *array* leaves of a params pytree to ``dtype``.

    Integer/bool arrays and non-array leaves (Python scalars or arbitrary
    objects inside ``MPPIParams.model_params``) pass through untouched —
    weakly-typed Python floats don't promote the scan carry, and assuming
    every leaf has ``.dtype`` crashed on them (round-2 review finding).
    """

    def cast(a):
        if not hasattr(a, "dtype"):
            return a
        return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a

    return jax.tree.map(cast, tree)


def _time_indexed(cfg, dynamics_step):
    """Uniform 3-arg view of the discrete transition.

    With ``cfg.time_varying_dynamics`` the user's F(x, u, t) is called as-is
    (t = int32 rollout step index, the pytorch_mppi `dynamics(states,
    actions, t)` convention, test/test_mppi_diff_obs.py:28-42); otherwise the
    2-arg F(x, u) is wrapped and t ignored.
    """
    if cfg.time_varying_dynamics:
        return dynamics_step
    return lambda x, v, t: dynamics_step(x, v)


def mppi_step(
    cfg: MPPIConfig,
    dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    params: MPPIParams,
    state: MPPIState,
    x0: jnp.ndarray,
    noise: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    rollout_fn: Optional[Callable] = None,
) -> Tuple[jnp.ndarray, MPPIState, MPPIAux]:
    """One MPPI control tick: sample → rollout → weight → update → shift.

    ``rollout_fn(params, ctx, u, eps, x0, axis_name=None) -> (S, wp_carried)``
    replaces the scan rollout with a kernel (:func:`make_rollout_kernel`); it
    implements the same semantics (clamped v, stage + energy + terminal
    accumulation) and returns ``wp_carried``, the furthest carried waypoint
    index of its samples, under ``waypoint_carry="rollout"`` (else None).

    ``dynamics_step`` is the *discrete* transition F(x, u) (Euler by default,
    matching mppi_differential_drive.py:182-198). ``noise`` injects a fixed ε
    (K, T, dim_u) for oracle parity; otherwise ε is drawn from the carried key.

    ``axis_name`` enables sample-sharded execution under ``shard_map``: each
    device rolls out its K/n shard and the three cross-sample reductions —
    ρ = min S (pmin), η = Σ exp (psum), and the weighted-noise sum (psum) —
    are collectives over the mesh (SURVEY §2.10). cfg.num_samples stays the
    *global* K.
    """
    K, T = cfg.num_samples, cfg.horizon
    u = state.u_prev
    x0 = x0.astype(u.dtype)
    n_shards = 1 if axis_name is None else jax.lax.axis_size(axis_name)
    local_K = K // n_shards
    # Keep the whole tick in one dtype (f32 on the hot path); under x64 test
    # mode, float64 params would otherwise promote the scan carry.
    params = unify_float_dtype(params, u.dtype)

    if cfg.waypoint_carry not in ("tick", "rollout"):
        raise ValueError(f"waypoint_carry must be 'tick' or 'rollout': {cfg.waypoint_carry!r}")
    if cfg.waypoint_persist not in ("none", "max"):
        raise ValueError(f"waypoint_persist must be 'none' or 'max': {cfg.waypoint_persist!r}")

    # Advance the waypoint window to the vehicle position (tick-level, pure).
    wp_idx, _ = nearest_waypoint(
        params.ref_path, x0[:2], state.waypoint_idx, cfg.waypoint_search_len
    )
    ctx = CostContext(params=params, waypoint_start=wp_idx)
    rollout_carry = cfg.waypoint_carry == "rollout"

    key, sub = jax.random.split(state.key)
    if noise is None:
        if axis_name is not None:
            sub = jax.random.fold_in(sub, jax.lax.axis_index(axis_name))
        eps = sample_noise(sub, params.sigma, local_K, T, dtype=u.dtype)
    else:
        eps = noise.astype(u.dtype)

    if rollout_fn is not None:
        S, wp_carried = rollout_fn(params, ctx, u, eps, x0, axis_name=axis_name)
    else:
        S, wp_carried = _scan_rollout(
            cfg, dynamics_step, stage_cost, terminal_cost, params, ctx, u, eps,
            x0, axis_name,
        )

    wp_status = None  # non-None only when the carry is a persisted lookahead
    if rollout_carry and cfg.waypoint_persist == "max":
        # persist the furthest carried index into the next tick's window
        # (the pure analog of the reference's prev_way_point_idx retaining the
        # last sample's final index, mppi_differential_drive.py:218). The
        # end-of-path status keeps judging the TICK-level index — the
        # persisted one is a lookahead that reaches the end early.
        wp_status = wp_idx
        if axis_name is not None:
            wp_carried = jax.lax.pmax(wp_carried, axis_name)
        wp_idx = wp_carried

    # Softmax weights with ρ = min S (mppi_differential_drive.py:167-180).
    # Sharded: ρ via pmin, normalizer η via psum — the only cross-device scalars.
    inv_temp = jnp.asarray(cfg.inv_temperature, dtype=u.dtype)
    rho = jnp.min(S)
    if axis_name is not None:
        rho = jax.lax.pmin(rho, axis_name)
    m = jnp.exp(-inv_temp * (S - jax.lax.stop_gradient(rho)))
    eta = jnp.sum(m)
    if axis_name is not None:
        eta = jax.lax.psum(eta, axis_name)
    w = m / eta

    # Weighted noise over the unclamped ε (…:132-135). Full f32 precision: a
    # TF32 product here would perturb the update by ~1e-3 relative.
    w_eps = jnp.einsum("k,ktu->tu", w, eps, precision=_HIGHEST)
    if axis_name is not None:
        w_eps = jax.lax.psum(w_eps, axis_name)
    return _mppi_tail(
        cfg, dynamics_step, params, state, ctx, x0, u, key, wp_idx, S, w, w_eps,
        status_idx=wp_status,
    )


def _scan_rollout(
    cfg, dynamics_step, stage_cost, terminal_cost, params, ctx, u, eps, x0,
    axis_name,
):
    """The plain XLA rollout: a ``lax.scan`` over the horizon whose carry holds
    all local samples. Returns (S, wp_carried) like a ``rollout_fn``."""
    K, T = cfg.num_samples, cfg.horizon
    local_K = eps.shape[0]
    wp_idx = ctx.waypoint_start
    # Exploration split (mppi_differential_drive.py:116-119): sample index
    # mask over *global* sample indices so sharding preserves semantics.
    k_idx = jnp.arange(local_K, dtype=jnp.float32)
    if axis_name is not None:
        k_idx = k_idx + jax.lax.axis_index(axis_name).astype(jnp.float32) * local_K
    exploit = (k_idx < (1.0 - cfg.exploration) * K)[:, None, None]
    v = jnp.where(exploit, u[None] + eps, eps)  # (K, T, nu)
    v = jnp.clip(v, params.u_min, params.u_max)  # _g, applied to the buffer

    # γ·u_tᵀΣ⁻¹v_{k,t} for all (k, t) in one einsum, at full f32 precision
    # (the kernel path computes the same term elementwise).
    energy = jnp.einsum("tj,ktj->kt", _energy_coeffs(cfg, u, params), v, precision=_HIGHEST)

    v_time = jnp.swapaxes(v, 0, 1)  # (T, K, nu) — time-leading for scan

    # M-repeat rollouts (pytorch_mppi rollout_samples, test_mppi_diff_obs.py
    # :122-151): the same action sequence is rolled M times — meaningful
    # when dynamics_step is stochastic — with cost averaged over M and a
    # discounted rollout-variance penalty added.
    M = max(1, cfg.num_rollout_repeats)

    rollout_carry = cfg.waypoint_carry == "rollout"
    dyn_t = _time_indexed(cfg, dynamics_step)

    def body(carry, inp):
        x, s, var, wpi = carry
        v_t, e_t, t = inp
        if M > 1:  # repeat the same actions across the M rollouts
            v_t = jnp.broadcast_to(v_t[None], (M,) + v_t.shape)
        x = dyn_t(x, v_t, t)  # (K, nx) or (M, K, nx)
        if rollout_carry:
            # per-rollout monotone window advance — the pure form of the
            # reference's stateful in-cost lookup (see MPPIConfig.
            # waypoint_carry). One lookup per (k, t), anchored at the
            # PRE-update carry exactly like the reference's
            # _get_nearest_waypoint(update_prev_idx=True) at :228: its
            # ref rows feed the cost (via ctx.waypoint_ref) and its
            # argmin becomes the next carry.
            idx_new, ref = nearest_waypoint_carried(
                params.ref_path, x[..., :2], wpi, cfg.waypoint_search_len
            )
            ctx_t = ctx._replace(waypoint_start=wpi, waypoint_ref=ref)
            wpi = idx_new
        else:
            ctx_t = ctx
        c = stage_cost(x, t, ctx_t) + e_t
        if params.control_weight is not None:
            # pytorch_mppi spec action cost aᵀRa on the CLAMPED action
            # (test/test_mppi_diff_obs.py:48-53; pytorch_mppi passes the
            # bounded perturbed action into running_cost)
            c = c + jnp.sum(params.control_weight * v_t * v_t, axis=-1)
        if M > 1:
            disc = jnp.asarray(cfg.rollout_var_discount, u.dtype) ** t.astype(u.dtype)
            var = var + jnp.var(c, axis=0) * disc
        if cfg.accumulation == CostAccumulation.SUM:
            s = s + c
        else:  # LAST: reference overwrite quirk (mppi_differential_drive.py:124)
            s = c
        return (x, s, var, wpi), None

    batch = (local_K,) if M == 1 else (M, local_K)
    x_init = jnp.broadcast_to(x0, batch + x0.shape)
    s_init = jnp.zeros(batch, dtype=u.dtype)
    var_init = jnp.zeros((local_K,), dtype=u.dtype)
    wpi_init = jnp.broadcast_to(wp_idx, batch).astype(jnp.int32)
    ts = jnp.arange(T, dtype=jnp.int32)
    (x_final, S, cost_var, wpi_final), _ = jax.lax.scan(
        body,
        (x_init, s_init, var_init, wpi_init),
        (v_time, jnp.swapaxes(energy, 0, 1), ts),
    )
    term_ctx = ctx._replace(waypoint_start=wpi_final) if rollout_carry else ctx
    S = S + terminal_cost(x_final, term_ctx)
    if M > 1:
        S = jnp.mean(S, axis=0) + cfg.rollout_var_cost * cost_var
    return S, (jnp.max(wpi_final) if rollout_carry else None)


def _energy_coeffs(cfg, u, params):
    """(T, nu) rows γ·u_tᵀΣ⁻¹ of the information-theoretic control cost."""
    return cfg.gamma * jnp.matmul(u, sigma_inverse(params.sigma), precision=_HIGHEST)


def _mppi_tail(
    cfg, dynamics_step, params, state, ctx, x0, u, key, wp_idx, S, w, w_eps,
    status_idx=None,
):
    """Shared tick tail: smoothing, update, shift, diagnostics, failure flags.

    ``status_idx`` (default: ``wp_idx``) is the index the end-of-path flag is
    judged against — with ``waypoint_persist="max"`` the carried ``wp_idx`` is
    a deliberate LOOKAHEAD (it can sit near the path end many ticks before the
    robot does), so the status bit uses the tick-level robot-position index
    instead."""
    T = cfg.horizon
    # Smoothing filter on the weighted noise (…:136-141).
    w_eps = apply_filter(w_eps, cfg.filter, cfg.filter_window, cfg.savgol_polyorder)
    u_new = u + w_eps

    # Optimal trajectory of the updated (clamped-in-rollout) sequence (…:144-149).
    # Provenance note: the reference's viz loop applies u[t-1] starting with
    # u[-1] (mppi_differential_drive.py:144-149, an off-by-one in a
    # diagnostic-only path); here u_new[0..T-1] is applied in order — the
    # off-by-one is deliberately not replicated (same policy as the other
    # documented quirks in the module docstring).
    if cfg.compute_optimal_traj:
        dyn_t = _time_indexed(cfg, dynamics_step)

        def opt_body(x, inp):
            u_t, t = inp
            x = dyn_t(x, jnp.clip(u_t, params.u_min, params.u_max), t)
            return x, x

        _, optimal_traj = jax.lax.scan(
            opt_body, x0, (u_new, jnp.arange(T, dtype=jnp.int32))
        )
    else:
        optimal_traj = jnp.zeros((T,) + x0.shape, dtype=u.dtype)

    # Failure detection (SURVEY §5.3): reject non-finite updates, holding the
    # previous sequence (warn-and-continue semantics); flag end-of-path.
    finite = jnp.all(jnp.isfinite(u_new))
    u_new = jnp.where(finite, u_new, u)
    sidx = wp_idx if status_idx is None else status_idx
    end_of_path = sidx >= params.ref_path.shape[0] - 1
    status = (
        end_of_path.astype(jnp.int32)
        + 2 * jnp.logical_not(finite).astype(jnp.int32)
    )

    # Receding-horizon shift (…:162-163).
    u_shift = jnp.concatenate([u_new[1:], u_new[-1:]], axis=0)
    new_state = MPPIState(u_prev=u_shift, waypoint_idx=wp_idx, key=key)
    aux = MPPIAux(
        costs=S,
        weights=w,
        optimal_traj=optimal_traj,
        waypoint_idx=wp_idx,
        status=status,
    )
    return u_new[0], new_state, aux


def sampled_trajectories(
    cfg: MPPIConfig,
    dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    params: MPPIParams,
    state: MPPIState,
    x0: jnp.ndarray,
    noise: jnp.ndarray,
    costs: jnp.ndarray,
    top_fraction: float = 1.0,
) -> jnp.ndarray:
    """Re-roll sampled sequences for visualization, cost-sorted (best first).

    Separate from the hot path so [K,T,nx] is only materialized on demand —
    mirrors the viz re-rollout at mppi_differential_drive.py:151-159 and the
    top-10% extraction of test/test_mppi_diff_obs.py:102-110.
    """
    K = cfg.num_samples
    u = state.u_prev
    k_idx = jnp.arange(K, dtype=jnp.float32)
    exploit = (k_idx < (1.0 - cfg.exploration) * K)[:, None, None]
    v = jnp.where(exploit, u[None] + noise, noise)
    v = jnp.clip(v, params.u_min, params.u_max)

    dyn_t = _time_indexed(cfg, dynamics_step)

    def body(x, inp):
        v_t, t = inp
        x = dyn_t(x, v_t, t)
        return x, x

    x_init = jnp.broadcast_to(x0, (K,) + x0.shape)
    _, trajs = jax.lax.scan(
        body,
        x_init,
        (jnp.swapaxes(v, 0, 1), jnp.arange(cfg.horizon, dtype=jnp.int32)),
    )  # (T, K, nx)
    trajs = jnp.swapaxes(trajs, 0, 1)  # (K, T, nx)
    order = jnp.argsort(costs)
    n_top = max(1, int(K * top_fraction))
    return jnp.take(trajs, order[:n_top], axis=0)


def make_rollout_kernel(
    cfg: MPPIConfig,
    tile_dynamics: Callable,
    spec: TrackingSpec,
    nx: Optional[int] = None,
    *,
    interpret: bool = False,
) -> Callable:
    """Bind the GPU rollout kernel (ops/pallas/rollout.py) as ``rollout_fn``.

    ``tile_dynamics`` is the tile form of the discrete step (models/tile.py);
    ``spec`` the tracking cost's constants (``make_tracking_costs(...)``'s
    ``tracking_spec``). The kernel computes S for this device's samples; the
    reductions over K stay in ``mppi_step`` (collectives when sharded, vmap
    for fleets). ``interpret=True`` runs it in the Pallas interpreter — the
    CPU tests' route to the kernel's arithmetic.
    """
    from ..ops.pallas.rollout import rollout_costs

    if cfg.num_rollout_repeats > 1:
        raise ValueError(
            "the rollout kernel does not implement num_rollout_repeats>1 "
            "(M-repeat variance cost) — use the scan path"
        )
    nx = cfg.dim_x if nx is None else nx
    rollout_carry = cfg.waypoint_carry == "rollout"

    def rollout(params, ctx, u, eps, x0, axis_name=None):
        P = params.ref_path.shape[0]
        if rollout_carry:
            # pre-gathered carry window from the tick anchor with CLAMPED
            # indices (rows past the path end duplicate P−1 and resolve to the
            # genuine first index by the first-tie rule — the clip rule of
            # ops/waypoints.nearest_waypoint_carried)
            span = min(cfg.waypoint_search_len, P)
            Wlen = min(
                cfg.carry_window_len
                if cfg.carry_window_len is not None
                else cfg.waypoint_search_len + cfg.horizon,
                P,
            )
            start = jnp.clip(ctx.waypoint_start, 0, P - 1)
            gidx = jnp.minimum(start + jnp.arange(Wlen, dtype=jnp.int32), P - 1)
            window = jnp.take(params.ref_path, gidx, axis=0)
        else:
            span = 0
            Wlen = min(cfg.waypoint_search_len, P)
            start = jnp.clip(ctx.waypoint_start, 0, max(P - Wlen, 0))
            window = jax.lax.dynamic_slice_in_dim(params.ref_path, start, Wlen, axis=0)
        k_offset = 0.0
        if axis_name is not None:
            # global sample index = shard offset + local index, so the
            # exploration split stays a property of the *global* K
            k_offset = jax.lax.axis_index(axis_name).astype(jnp.float32) * eps.shape[0]
        out = rollout_costs(
            eps, u, _energy_coeffs(cfg, u, params), x0, window,
            params.stage_weight, params.terminal_weight,
            params.u_min, params.u_max,
            (1.0 - cfg.exploration) * cfg.num_samples, k_offset,
            params.obstacles, params.obstacle_velocities, params.control_weight,
            step_tile=tile_dynamics,
            spec=spec,
            nx=nx,
            nu=cfg.dim_u,
            T=cfg.horizon,
            dt=float(cfg.dt),
            last_only=cfg.accumulation == CostAccumulation.LAST,
            step_takes_t=cfg.time_varying_dynamics,
            carry_W=span,
            interpret=interpret,
        )
        if not rollout_carry:
            return out.astype(u.dtype), None
        S, idx = out
        return S.astype(u.dtype), jnp.minimum(start + jnp.max(idx), P - 1)

    return rollout


class MPPISolver:
    """Convenience wrapper: binds config + dynamics + costs, jits the step.

    Covers the constructor surface of MPPIAlgorithms
    (mppi_differential_drive.py:44-85) / MPPIRacecarController
    (mppi_race_car_obstacle.py:11-62) with explicit state instead of mutation.

    The rollout runs in the GPU kernel (:func:`make_rollout_kernel`) when the
    platform is a GPU and the problem is one the kernel implements — tracking
    costs from :func:`make_tracking_costs`, a ``tile_dynamics`` form of the
    dynamics, single rollouts — and in the XLA scan otherwise. ``use_pallas``
    overrides the choice (True demands the kernel, False the scan);
    ``rollout_fn`` binds a rollout outright.
    """

    def __init__(
        self,
        cfg: MPPIConfig,
        dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
        stage_cost: StageCost,
        terminal_cost: TerminalCost,
        use_pallas: Optional[bool] = None,
        rollout_fn: Optional[Callable] = None,
        tile_dynamics: Optional[Callable] = None,
    ) -> None:
        self.cfg = cfg
        self.dynamics_step = dynamics_step
        if rollout_fn is None:
            rollout_fn = _choose_rollout(cfg, stage_cost, tile_dynamics, use_pallas)
        self.rollout_fn = rollout_fn
        self._step = jax.jit(
            functools.partial(
                mppi_step,
                cfg,
                dynamics_step,
                stage_cost,
                terminal_cost,
                rollout_fn=rollout_fn,
            )
        )
        self._sampled = jax.jit(
            functools.partial(sampled_trajectories, cfg, dynamics_step),
            static_argnames=("top_fraction",),
        )

    def init(self, key: Optional[jax.Array] = None) -> MPPIState:
        return MPPIState.init(self.cfg, key)

    def step(
        self,
        params: MPPIParams,
        state: MPPIState,
        x0: jnp.ndarray,
        noise: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, MPPIState, MPPIAux]:
        return self._step(params, state, x0, noise)

    def sampled_trajectories(self, params, state, x0, noise, costs, top_fraction=1.0):
        return self._sampled(params, state, x0, noise, costs, top_fraction=top_fraction)


def _choose_rollout(cfg, stage_cost, tile_dynamics, use_pallas):
    """The GPU kernel where the platform is a GPU and the kernel implements
    the problem; the scan path (None) otherwise."""
    spec = getattr(stage_cost, "tracking_spec", None)
    missing = [
        why
        for why, bad in (
            ("tile_dynamics (the tile form of the dynamics)", tile_dynamics is None),
            ("tracking costs from make_tracking_costs", spec is None),
            ("num_rollout_repeats == 1", cfg.num_rollout_repeats > 1),
        )
        if bad
    ]
    if use_pallas is None:
        use_pallas = not missing and platform() == "gpu"
    if not use_pallas:
        return None
    if missing:
        raise ValueError("the rollout kernel needs " + ", ".join(missing))
    return make_rollout_kernel(cfg, tile_dynamics, spec)


__all__ = [
    "MPPIState",
    "MPPIAux",
    "CostContext",
    "make_tracking_costs",
    "make_rollout_kernel",
    "mppi_step",
    "sampled_trajectories",
    "MPPISolver",
]
