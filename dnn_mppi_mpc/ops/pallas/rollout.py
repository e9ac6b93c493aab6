"""MPPI rollout + cost kernel for the GPU (Pallas through Triton).

One thread per sample: each grid program owns a block of ``block_k``
consecutive samples and runs the whole horizon for them — the T loop and the
nearest-waypoint window search stay inside the kernel, with the rollout state
in registers. The kernel writes the per-sample cost S (K,); noise sampling,
the softmax, the weighted-noise sum, the filter, the update and the shift
stay in XLA (solvers/mppi.py::mppi_step), so a grid program carries nothing
to the next one.

Dynamics enter as a **tile step** (models/tile.py):

    step_tile(xs: tuple[nx arrays], vs: tuple[nu arrays]) -> tuple[nx arrays]

operating elementwise on (block_k,) sample vectors, with dt and the model
constants baked in. Cost semantics are those of ``make_tracking_costs``
(solvers/mppi.py), fixed by its :class:`~dnn_mppi_mpc.ops.costs.TrackingSpec`:

  * nearest-waypoint window lookup over (x, y), first-argmin tie rule, refs
    for the first ``n_track`` state dims; per-sample carried window
    (``waypoint_carry="rollout"``) as a masked running min over a
    pre-gathered window;
  * optional wrap-yaw on dim 2 (yaw → [0, 2π) before differencing);
  * γ·uᵀΣ⁻¹v energy term, exploration split, in-rollout clamp, optional
    action cost aᵀ·diag(cw)·a on the clamped action;
  * collision: none, robot circle, vehicle polygon (×COLLISION_PENALTY) or
    soft exponential, with optional in-rollout obstacle drift;
  * SUM or LAST accumulation.

ε arrives from outside (drawn by ``jax.random`` exactly as the scan path
draws it) laid out (nu, T, K) so a block's loads coalesce; K is padded to a
multiple of the block and the padded tail is sliced off.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..costs import COLLISION_PENALTY, VEHICLE_OUTLINE_X, VEHICLE_OUTLINE_Y, TrackingSpec

TileStep = Callable[[Sequence[jnp.ndarray], Sequence[jnp.ndarray]], Sequence[jnp.ndarray]]

# Samples per grid program and warps per program (one sample per thread).
# Small blocks spread the K samples over every SM of the card: each sample
# is one long dependent chain, so the rollout is latency-bound and wants as
# many schedulers busy as possible.
BLOCK_K = 32
NUM_WARPS = 1
# Windows up to this length are searched by an unrolled Python loop; longer
# ones (the race car's W=200) by an in-kernel loop over the window rows.
_UNROLL_W = 32
_TWO_PI = 6.283185307179586


def _rollout_kernel(
    scal_ref,  # (n_scal,) packed f32 runtime scalars (layout: _pack_scalars)
    u_ref,  # (T, nu) nominal controls
    a_ref,  # (T, nu) γ·u_tᵀΣ⁻¹ rows (energy coefficients)
    win_ref,  # (W, n_track) waypoint window
    obs_ref,  # (max(n_obs, 1), 5) obstacles (x, y, r, vx, vy)
    eps_ref,  # (nu, T, Kp) ε, sample index contiguous
    S_ref,  # out (Kp,) sample costs
    *idx_ref,  # out (Kp,) int32 final carried window index (rollout carry)
    step_tile: TileStep,
    spec: TrackingSpec,
    nx: int,
    nu: int,
    n_track: int,
    T: int,
    W: int,
    n_obs: int,
    dt: float,
    block_k: int,
    last_only: bool,
    moving_obs: bool,
    control_cost: bool,
    step_takes_t: bool,
    carry_W: int,
):
    f32 = jnp.float32
    k0 = pl.program_id(0) * block_k
    lanes = pl.ds(k0, block_k)
    zero = jnp.zeros((block_k,), f32)

    n_exploit = scal_ref[0]
    k_offset = scal_ref[1]
    o = 2
    umin = [scal_ref[o + j] for j in range(nu)]
    o += nu
    umax = [scal_ref[o + j] for j in range(nu)]
    o += nu
    sw = [scal_ref[o + i] for i in range(n_track)]
    o += n_track
    tw = [scal_ref[o + i] for i in range(n_track)]
    o += n_track
    x0 = [scal_ref[o + i] for i in range(nx)]
    o += nx
    cw = [scal_ref[o + j] for j in range(nu)] if control_cost else None

    k_idx = (k0 + jax.lax.iota(jnp.int32, block_k)).astype(f32) + k_offset
    exploit = k_idx < n_exploit
    obs = [tuple(obs_ref[q, c] for c in range(5)) for q in range(n_obs)]
    win = (
        [tuple(win_ref[w, i] for i in range(n_track)) for w in range(W)]
        if W <= _UNROLL_W
        else None
    )

    def d2_to(xc, yc, wx, wy):
        return (xc - wx) * (xc - wx) + (yc - wy) * (yc - wy)

    def window_refs(xc, yc):
        """Running-min nearest waypoint (first-argmin tie rule)."""
        if win is not None:
            dmin = d2_to(xc, yc, win[0][0], win[0][1])
            refs = [zero + win[0][i] for i in range(n_track)]
            for w in range(1, W):
                d = d2_to(xc, yc, win[w][0], win[w][1])
                better = d < dmin
                dmin = jnp.where(better, d, dmin)
                refs = [jnp.where(better, win[w][i], refs[i]) for i in range(n_track)]
            return refs

        def wbody(w, carry):
            dmin, refs = carry[0], carry[1:]
            d = d2_to(xc, yc, win_ref[w, 0], win_ref[w, 1])
            better = d < dmin
            return (jnp.where(better, d, dmin),) + tuple(
                jnp.where(better, win_ref[w, i], refs[i]) for i in range(n_track)
            )

        init = (d2_to(xc, yc, win_ref[0, 0], win_ref[0, 1]),) + tuple(
            zero + win_ref[0, i] for i in range(n_track)
        )
        return list(jax.lax.fori_loop(1, W, wbody, init)[1:])

    def window_refs_carried(xc, yc, idx):
        """Per-sample monotone lookup: running min over window rows
        [idx, idx + carry_W) of the pre-gathered window."""

        def visit(w, wrow, carry):
            dmin, idx_new, refs = carry
            d = d2_to(xc, yc, wrow[0], wrow[1])
            better = (idx <= w) & (idx > w - carry_W) & (d < dmin)
            return (
                jnp.where(better, d, dmin),
                jnp.where(better, w, idx_new),
                [jnp.where(better, wrow[i], refs[i]) for i in range(n_track)],
            )

        carry = (zero + f32(1.0e30), idx, [zero for _ in range(n_track)])
        if win is not None:
            for w in range(W):
                carry = visit(jnp.int32(w), win[w], carry)
        else:

            def wbody(w, c):
                dmin, idx_new, *refs = c
                row = [win_ref[w, i] for i in range(n_track)]
                dmin, idx_new, refs = visit(w, row, (dmin, idx_new, refs))
                return (dmin, idx_new, *refs)

            dmin, idx_new, *refs = jax.lax.fori_loop(
                0, W, wbody, (carry[0], carry[1], *carry[2])
            )
            carry = (dmin, idx_new, refs)
        return carry[2], carry[1]

    def tracking(xs, weights, refs):
        c = zero
        for i in range(n_track):
            xi = xs[i]
            if spec.wrap_yaw and i == 2:
                # yaw → [0, 2π) before differencing; the ref is not wrapped
                xi = jnp.mod(xi + f32(_TWO_PI), f32(_TWO_PI))
            c = c + weights[i] * (xi - refs[i]) * (xi - refs[i])
        return c

    def collision(xs, t_f):
        """Obstacle cost at rollout time t_f (None: initial positions — the
        terminal-cost rule)."""
        if spec.collision == "none" or n_obs == 0:
            return zero
        xc, yc = xs[0], xs[1]
        if spec.collision == "polygon":
            c, s = jnp.cos(xs[2]), jnp.sin(xs[2])
            hl = 0.5 * spec.vehicle_length * spec.safety_margin_rate
            hw = 0.5 * spec.vehicle_width * spec.safety_margin_rate
            pts = [
                (bx * hl * c - by * hw * s + xc, bx * hl * s + by * hw * c + yc)
                for bx, by in zip(VEHICLE_OUTLINE_X, VEHICLE_OUTLINE_Y)
            ]
        pen = zero
        for ox, oy, orad, ovx, ovy in obs:
            if moving_obs and t_f is not None:
                ox = ox + ovx * t_f
                oy = oy + ovy * t_f
            if spec.collision == "circle":
                rr = orad + f32(spec.robot_radius * spec.safety_margin_rate)
                pen = jnp.where(d2_to(xc, yc, ox, oy) < rr * rr, f32(1.0), pen)
            elif spec.collision == "polygon":
                for px, py in pts:
                    pen = jnp.where(d2_to(px, py, ox, oy) < orad * orad, f32(1.0), pen)
            else:  # soft exponential
                d = jnp.sqrt(d2_to(xc, yc, ox, oy) + f32(1e-12))
                dist = f32(spec.soft_safety_distance)
                pen = pen + jnp.where(d < dist, jnp.exp(dist - d), f32(0.0))
        if spec.collision == "soft":
            return pen * f32(spec.soft_weight)
        return pen * f32(COLLISION_PENALTY)

    carried = carry_W > 0

    def body(t, carry):
        xs, S = list(carry[:nx]), carry[nx]
        vs, energy, act = [], zero, zero
        for j in range(nu):
            e = eps_ref[j, t, lanes]
            v = jnp.clip(jnp.where(exploit, u_ref[t, j] + e, e), umin[j], umax[j])
            vs.append(v)
            energy = energy + a_ref[t, j] * v
            if control_cost:
                act = act + cw[j] * v * v
        args = (tuple(xs), tuple(vs), t) if step_takes_t else (tuple(xs), tuple(vs))
        xs = list(step_tile(*args))
        if carried:
            refs, idx = window_refs_carried(xs[0], xs[1], carry[nx + 1])
        else:
            refs = window_refs(xs[0], xs[1])
        c = tracking(xs, sw, refs) + collision(xs, t.astype(f32) * f32(dt))
        c = c + energy
        if control_cost:
            c = c + act
        S = c if last_only else S + c
        return tuple(xs) + (S,) + ((idx,) if carried else ())

    init = tuple(zero + x0[i] for i in range(nx)) + (zero,)
    if carried:
        init = init + (jnp.zeros((block_k,), jnp.int32),)
    out = jax.lax.fori_loop(0, T, body, init)
    xs, S = list(out[:nx]), out[nx]
    if carried:
        refs, _ = window_refs_carried(xs[0], xs[1], out[nx + 1])
        idx_ref[0][lanes] = out[nx + 1]
    else:
        refs = window_refs(xs[0], xs[1])
    S_ref[lanes] = S + tracking(xs, tw, refs) + collision(xs, None)


def _pack_scalars(n_exploit, k_offset, u_min, u_max, stage_w, term_w, x0, control_weight):
    f32 = jnp.float32
    parts = [
        jnp.reshape(jnp.asarray(n_exploit, f32), (1,)),
        jnp.reshape(jnp.asarray(k_offset, f32), (1,)),
        u_min.astype(f32),
        u_max.astype(f32),
        stage_w.astype(f32),
        term_w.astype(f32),
        x0.astype(f32),
    ]
    if control_weight is not None:
        parts.append(control_weight.astype(f32))
    return jnp.concatenate(parts)


def _pack_obstacles(obstacles, obstacle_velocities):
    """(n_obs, 2|3) centers(+radii) and optional velocities → (n_obs, 5)
    rows (x, y, r, vx, vy); one zero row when there are no obstacles."""
    f32 = jnp.float32
    if obstacles is None:
        return jnp.zeros((1, 5), f32)
    ob = obstacles.astype(f32)
    if ob.shape[1] == 2:
        ob = jnp.concatenate([ob, jnp.zeros((ob.shape[0], 1), f32)], axis=1)
    vel = (
        obstacle_velocities[..., :2].astype(f32)
        if obstacle_velocities is not None
        else jnp.zeros((ob.shape[0], 2), f32)
    )
    return jnp.concatenate([ob[:, :3], vel], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=(
        "step_tile", "spec", "nx", "nu", "T", "dt", "last_only",
        "step_takes_t", "carry_W", "interpret",
    ),
)
def rollout_costs(
    eps: jnp.ndarray,  # (K, T, nu) ε — the scan path's own draw
    u: jnp.ndarray,  # (T, nu) nominal sequence
    a: jnp.ndarray,  # (T, nu) γ·u_tᵀΣ⁻¹
    x0: jnp.ndarray,  # (nx,)
    window: jnp.ndarray,  # (W, ≥n_track) waypoint window
    stage_w: jnp.ndarray,  # (n_track,)
    term_w: jnp.ndarray,  # (n_track,)
    u_min: jnp.ndarray,  # (nu,)
    u_max: jnp.ndarray,  # (nu,)
    n_exploit,  # samples with global index below this perturb the nominal
    k_offset=0.0,  # global index of this shard's first sample
    obstacles: Optional[jnp.ndarray] = None,  # (n_obs, 2|3)
    obstacle_velocities: Optional[jnp.ndarray] = None,  # (n_obs, 2)
    control_weight: Optional[jnp.ndarray] = None,  # (nu,)
    *,
    step_tile: TileStep,
    spec: TrackingSpec,
    nx: int,
    nu: int,
    T: int,
    dt: float,
    last_only: bool = False,
    step_takes_t: bool = False,
    carry_W: int = 0,
    interpret: bool = False,
):
    """Per-sample rollout costs S (K,). With ``carry_W > 0`` (rollout-carried
    waypoint window of search span carry_W over the pre-gathered ``window``)
    also returns each sample's final local window index (K,) int32."""
    K = eps.shape[0]
    n_track = stage_w.shape[0]
    if term_w.shape[0] != n_track:
        raise ValueError(
            "the rollout kernel tracks one n_track for both costs — stage_weight "
            f"has {n_track} dims, terminal_weight {term_w.shape[0]}"
        )
    if n_track < 2 or window.shape[1] < n_track:
        raise ValueError(
            f"tracking needs (x, y) and a window with ≥ n_track={n_track} columns"
        )
    W = window.shape[0]
    block_k = BLOCK_K
    Kp = -(-K // block_k) * block_k
    eps_t = jnp.transpose(eps.astype(jnp.float32), (2, 1, 0))  # (nu, T, K)
    if Kp != K:
        eps_t = jnp.pad(eps_t, ((0, 0), (0, 0), (0, Kp - K)))
    n_obs = 0 if obstacles is None else obstacles.shape[0]

    kernel = functools.partial(
        _rollout_kernel,
        step_tile=step_tile,
        spec=spec,
        nx=nx,
        nu=nu,
        n_track=n_track,
        T=T,
        W=W,
        n_obs=n_obs,
        dt=dt,
        block_k=block_k,
        last_only=last_only,
        moving_obs=obstacle_velocities is not None,
        control_cost=control_weight is not None,
        step_takes_t=step_takes_t,
        carry_W=carry_W,
    )
    out_shape = [jax.ShapeDtypeStruct((Kp,), jnp.float32)]
    if carry_W > 0:
        out_shape.append(jax.ShapeDtypeStruct((Kp,), jnp.int32))
    out = pl.pallas_call(
        kernel,
        out_shape=tuple(out_shape),
        grid=(Kp // block_k,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="mppi_rollout",
    )(
        _pack_scalars(n_exploit, k_offset, u_min, u_max, stage_w, term_w, x0, control_weight),
        u.astype(jnp.float32),
        a.astype(jnp.float32),
        window[:, :n_track].astype(jnp.float32),
        _pack_obstacles(obstacles, obstacle_velocities),
        eps_t,
    )
    if carry_W > 0:
        return out[0][:K], out[1][:K]
    return out[0][:K]


__all__ = ["BLOCK_K", "TileStep", "rollout_costs"]
