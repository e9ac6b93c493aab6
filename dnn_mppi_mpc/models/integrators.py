"""Explicit integrators for discretizing continuous dynamics.

Replaces the reference's per-script Euler updates
(controllers/mppi_differential_drive.py:182-198), the hand-rolled RK4
(controllers/mpc_differential_drive_obstacle_static.py:334-356), and the
acados ERK integrator configuration (sim_method_num_stages=4, num_steps=3 at
controllers/mpc_differential_drive_obstacle_static.py:241-242).

All integrators are pure and broadcast over leading batch dims, so the same
code path serves single-state plants, K-sample MPPI rollouts and N-node
shooting discretizations.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Dynamics = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def euler_step(f: Dynamics, x: jnp.ndarray, u: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Forward-Euler step — the MPPI rollout integrator
    (controllers/mppi_differential_drive.py:194-196)."""
    return x + f(x, u) * dt


def rk4_step(f: Dynamics, x: jnp.ndarray, u: jnp.ndarray, dt: float) -> jnp.ndarray:
    """Classic RK4 step (controllers/mpc_differential_drive_obstacle_static.py:334-340)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def erk_step(
    f: Dynamics, x: jnp.ndarray, u: jnp.ndarray, dt: float, num_steps: int = 3
) -> jnp.ndarray:
    """RK4 with ``num_steps`` substeps over one control interval — matches acados
    ERK with sim_method_num_stages=4, sim_method_num_steps=3
    (controllers/mpc_differential_drive_obstacle_static.py:241-242).

    The substep loop is unrolled (num_steps is small and static) so XLA fuses
    the whole interval into one kernel.
    """
    h = dt / num_steps
    for _ in range(num_steps):
        x = rk4_step(f, x, u, h)
    return x


def _gauss_legendre_tableau(num_stages: int):
    """Collocation Butcher tableau (c, A, b) for Gauss-Legendre nodes.

    Computed numerically at trace/construction time: a_ij = ∫₀^{c_i} ℓ_j,
    b_j = ∫₀¹ ℓ_j with ℓ_j the Lagrange basis on the shifted Legendre roots —
    exact to float precision for any stage count (acados uses the same
    collocation family for its IRK integrator).
    """
    import numpy as np

    nodes, _ = np.polynomial.legendre.leggauss(num_stages)
    c = 0.5 * (nodes + 1.0)  # [-1,1] → [0,1]
    A = np.zeros((num_stages, num_stages))
    b = np.zeros(num_stages)
    for j in range(num_stages):
        # Lagrange basis ℓ_j as polynomial coefficients
        lj = np.poly1d([1.0])
        for m in range(num_stages):
            if m != j:
                lj = lj * np.poly1d([1.0, -c[m]]) / (c[j] - c[m])
        integ = lj.integ()
        b[j] = integ(1.0) - integ(0.0)
        for i in range(num_stages):
            A[i, j] = integ(c[i]) - integ(0.0)
    return c, A, b


def irk_step(
    f: Dynamics,
    x: jnp.ndarray,
    u: jnp.ndarray,
    dt: float,
    num_stages: int = 4,
    num_steps: int = 3,
    newton_iters: int = 3,
) -> jnp.ndarray:
    """Implicit Runge-Kutta (Gauss-Legendre collocation) step.

    JAX equivalent of acados' IRK integrator as configured by the
    four-wheel dynamic NMPC (controllers/mpc_differential_dynamics.py:198,
    sim_method_num_stages=4, sim_method_num_steps=3): A-stable, so stiff
    torque/tire dynamics stay bounded at control-rate dt where explicit RK
    blows up. The stage equations K_i = f(x + hΣ_j a_ij K_j, u) are solved by
    a fixed number of full Newton steps on the stacked (s·nx) system — static
    control flow, ``jax.jacfwd``-differentiable end-to-end so the SQP engine
    linearizes through it exactly like through ERK.

    Broadcasts over leading batch dims like the explicit integrators (the
    batch is flattened and vmapped over the single-state Newton solver).
    """
    import numpy as np

    if x.ndim > 1:
        batch = x.shape[:-1]
        xf = x.reshape((-1, x.shape[-1]))
        uf = jnp.broadcast_to(u, batch + u.shape[-1:]).reshape(
            (-1, u.shape[-1])
        )
        out = jax.vmap(
            lambda xi, ui: irk_step(
                f, xi, ui, dt, num_stages, num_steps, newton_iters
            )
        )(xf, uf)
        return out.reshape(x.shape)

    _, A_np, b_np = _gauss_legendre_tableau(num_stages)
    A = jnp.asarray(A_np, dtype=x.dtype)
    b = jnp.asarray(b_np, dtype=x.dtype)
    nx = x.shape[-1]
    s = num_stages
    h = dt / num_steps
    eye = jnp.eye(s * nx, dtype=x.dtype)

    def substep(x):
        K = jnp.broadcast_to(f(x, u), (s, nx))  # explicit-Euler stage init

        def newton(K, _):
            X_st = x[None, :] + h * (A @ K)  # (s, nx) stage states
            F = jax.vmap(lambda xs: f(xs, u))(X_st)
            J = jax.vmap(lambda xs: jax.jacfwd(lambda q: f(q, u))(xs))(X_st)
            # ∂r_i/∂K_j = δ_ij I − h·a_ij·J_i  with r = K − F
            M = eye - h * (
                A[:, :, None, None] * J[:, None, :, :]
            ).transpose(0, 2, 1, 3).reshape(s * nx, s * nx)
            r = (K - F).reshape(s * nx)
            dK = jnp.linalg.solve(M, -r)
            return K + dK.reshape(s, nx), None

        K, _ = jax.lax.scan(newton, K, None, length=newton_iters)
        return x + h * (b @ K)

    for _ in range(num_steps):
        x = substep(x)
    return x


def discretize(
    f: Dynamics,
    dt: float,
    method: str = "euler",
    num_steps: int = 1,
    num_stages: int = 4,
) -> Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
    """Return a discrete transition ``F(x, u) -> x_next`` for the given method.

    ``num_stages`` applies to the IRK collocation order only (acados'
    sim_method_num_stages); the explicit methods ignore it.
    """
    if method == "euler":
        return lambda x, u: euler_step(f, x, u, dt)
    if method == "rk4":
        return lambda x, u: rk4_step(f, x, u, dt)
    if method == "erk":
        return lambda x, u: erk_step(f, x, u, dt, num_steps=num_steps)
    if method == "irk":
        return lambda x, u: irk_step(
            f, x, u, dt, num_stages=num_stages, num_steps=num_steps
        )
    raise ValueError(f"unknown integrator method: {method!r}")


def rollout(
    step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    u_seq: jnp.ndarray,
) -> jnp.ndarray:
    """Roll a discrete transition over a control sequence with ``lax.scan``.

    ``u_seq`` has shape (T, ..., dim_u) with time leading; returns the (T, ..., dim_x)
    trajectory of visited states (x1..xT). Batch dims ride along unvectorized —
    the batched MPPI rollout keeps K in the trailing batch axes of the carry.
    """

    def body(x, u):
        x_next = step(x, u)
        return x_next, x_next

    _, xs = jax.lax.scan(body, x0, u_seq)
    return xs


__all__ = ["euler_step", "rk4_step", "erk_step", "irk_step", "discretize", "rollout"]
