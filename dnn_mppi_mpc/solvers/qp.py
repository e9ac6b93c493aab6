"""Structure-exploiting QP solver: Riccati recursion + relaxed log barrier.

JAX replacement for acados' FULL_CONDENSING_HPIPM QP step
(controllers/mpc_differential_drive_obstacle_static.py:237): instead of a C
interior-point solver, the stage-structured QP

    min  Σᵢ ½δxᵢᵀQ̄ᵢδxᵢ + q̄ᵢᵀδxᵢ + ½δuᵢᵀR̄ᵢδuᵢ + r̄ᵢᵀδuᵢ
    s.t. δx_{i+1} = Aᵢδxᵢ + Bᵢδuᵢ + cᵢ,   δx₀ fixed,
         box bounds on x, u and linearized h-constraints

is solved by damped Newton on a **relaxed logarithmic barrier** (Feller &
Ebenbauer's relaxed-barrier MPC): each Newton step is an affine LQR solved by a
backward/forward Riccati ``lax.scan`` over the horizon — O(N·(nx+nu)³) with
tiny matrices, fully jittable and vmappable over scenario batches. The relaxed
barrier is globally defined (quadratic extension below δ), so infeasible warm
starts cannot blow up and no line search is required inside ``jit``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.sampling import small_lu_solve


def relaxed_barrier(
    w: jnp.ndarray, mu: float, delta: float, stiffness: Optional[float] = None
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(ψ, ψ', ψ'') of the relaxed log barrier at margin w (constraint w ≥ 0).

    ψ(w) = −μ ln w for w > δ; below δ a quadratic extension with C¹-matched
    gradient and **μ-independent stiffness** κ: ψ' = −μ/δ − κ(δ−w), ψ'' = κ.
    A μ-scaled extension (the textbook relaxed barrier) loses its restoring
    force as μ→0, letting violated constraints drift — the fixed κ keeps
    violations pinned to O(λ*/κ) while the log region sharpens toward the true
    active set.
    """
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    w_safe = jnp.maximum(w, delta)
    log_val = -mu * jnp.log(w_safe)
    log_grad = -mu / w_safe
    log_hess = mu / (w_safe * w_safe)
    dv = delta - w
    quad_val = -mu * jnp.log(delta) + (mu / delta) * dv + 0.5 * stiffness * dv * dv
    quad_grad = -mu / delta - stiffness * dv
    quad_hess = jnp.full_like(w, stiffness)
    use_log = w > delta
    return (
        jnp.where(use_log, log_val, quad_val),
        jnp.where(use_log, log_grad, quad_grad),
        jnp.where(use_log, log_hess, quad_hess),
    )


class LQRData(NamedTuple):
    """Affine time-varying LQR problem (all arrays stage-stacked)."""

    A: jnp.ndarray  # (N, nx, nx)
    B: jnp.ndarray  # (N, nx, nu)
    c: jnp.ndarray  # (N, nx) — dynamics residual / affine drift
    Qxx: jnp.ndarray  # (N+1, nx, nx) — stage 0 unused (δx₀ fixed)
    qx: jnp.ndarray  # (N+1, nx)
    Ruu: jnp.ndarray  # (N, nu, nu)
    ru: jnp.ndarray  # (N, nu)
    S: Optional[jnp.ndarray] = None  # (N, nu, nx) cross term δuᵀSδx — the
    # Gauss-Newton JuᵀWJx block of a general NONLINEAR_LS cost over (x, u)


def riccati_solve(data: LQRData, dx0: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve the affine LQR exactly: returns (δX (N+1,nx), δU (N,nu)).

    Backward sweep computes the value function (P, p) and gains (K, k); forward
    sweep rolls the linear dynamics — this is the Riccati equivalent of the
    condensed-QP factorization inside HPIPM, as a pair of ``lax.scan``s.
    """
    N = data.A.shape[0]
    nx = data.A.shape[1]
    reg = 1e-9

    def backward(carry, inp):
        P, p = carry
        A, B, c, Qxx, qx, Ruu, ru, S = inp
        PA = P @ A
        PB = P @ B
        Luu = Ruu + B.T @ PB
        Luu = 0.5 * (Luu + Luu.T) + reg * jnp.eye(Luu.shape[0], dtype=Luu.dtype)
        Lux = S + B.T @ PA
        lu = ru + B.T @ (p + P @ c)
        # Unrolled partial-pivot LU: jnp.linalg.solve on a 2×2 lowers to a
        # batched-LU path whose per-scan-step cost dominates the whole
        # backward sweep; pivoting (not Cholesky) because f32 cancellation
        # can leave Luu indefinite under barrier stiffness — see
        # ops/sampling.py::small_lu_solve.
        K = -small_lu_solve(Luu, Lux)
        k = -small_lu_solve(Luu, lu)
        P_new = Qxx + A.T @ PA + Lux.T @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = qx + A.T @ (p + P @ c) + Lux.T @ k
        return (P_new, p_new), (K, k)

    P_T = data.Qxx[N]
    p_T = data.qx[N]
    S = (
        data.S
        if data.S is not None
        else jnp.zeros((N, data.B.shape[2], nx), dtype=data.A.dtype)
    )
    stage_data = (
        data.A[::-1],
        data.B[::-1],
        data.c[::-1],
        data.Qxx[:-1][::-1],
        data.qx[:-1][::-1],
        data.Ruu[::-1],
        data.ru[::-1],
        S[::-1],
    )
    _, (K_rev, k_rev) = jax.lax.scan(backward, (P_T, p_T), stage_data)
    K, k = K_rev[::-1], k_rev[::-1]

    def forward(dx, inp):
        A, B, c, Ki, ki = inp
        du = Ki @ dx + ki
        dx_next = A @ dx + B @ du + c
        return dx_next, (dx, du)

    _, (dX, dU) = jax.lax.scan(forward, dx0, (data.A, data.B, data.c, K, k))
    # dX holds stages 0..N-1; append terminal state
    dx_T = data.A[-1] @ dX[-1] + data.B[-1] @ dU[-1] + data.c[-1]
    dX_full = jnp.concatenate([dX, dx_T[None]], axis=0)
    return dX_full, dU


def riccati_solve_parallel(
    data: LQRData, dx0: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Parallel-in-time affine LQR: O(log N) depth via associative scans.

    Mathematically identical to :func:`riccati_solve` (same minimizer, FP
    reordering only), but the backward value-function recursion and the
    forward rollout both become ``jax.lax.associative_scan``s — depth
    ⌈log₂N⌉ instead of N. On a latency-bound NMPC tick (tiny 3×3/5×5 stage
    matrices, the regime docs/PERF.md measures for the NMPC tick) this is the
    difference between 2N sequential matrix ops and ~2·log₂N wider ones.

    Construction (temporal-parallelization-of-LQR style, Särkkä &
    García-Fernández): each stage k carries the conditional cost-to-go
    between its boundary states,

        F_k(x, z) = ½xᵀJx − ηᵀx + T(z; Ax + b, C),

    where T is the minimum control cost of transporting Ax + b to z with
    Gramian C = B R⁻¹ Bᵀ. Composition (min over the intermediate state) is
    associative:

        A₁₂ = A₂ D A₁,            D = (I + C₁J₂)⁻¹
        b₁₂ = A₂ D (b₁ + C₁η₂) + b₂
        C₁₂ = A₂ D C₁ A₂ᵀ + C₂
        η₁₂ = A₁ᵀ Dᵀ (η₂ − J₂b₁) + η₁
        J₁₂ = A₁ᵀ Dᵀ J₂ A₁ + J₁            (Dᵀ = (I + J₂C₁)⁻¹)

    (I + C₁J₂ has eigenvalues ≥ 1 for PSD C, J — always invertible.)
    A reverse associative scan yields every suffix value function
    V_k(x) = ½xᵀJ_k x − η_kᵀx; gains are then extracted stage-parallel and
    the forward rollout is a prefix scan over affine-map composition.
    """
    N, nx = data.A.shape[0], data.A.shape[1]
    dtype = data.A.dtype
    reg = 1e-9
    I = jnp.eye(nx, dtype=dtype)

    if data.S is not None:
        # Cross terms δuᵀSδx are eliminated by the substitution
        # ũ = u + R⁻¹Sx, which maps the problem onto the S-free form this
        # routine solves:  Q̃ = Q − SᵀR⁻¹S,  q̃ = q − SᵀR⁻¹r,  Ã = A − BR⁻¹S.
        Ruu_reg = data.Ruu + reg * jnp.eye(data.Ruu.shape[-1], dtype=dtype)
        RinvS = jnp.linalg.solve(Ruu_reg, data.S)  # (N, nu, nx)
        Rinvr = jnp.linalg.solve(Ruu_reg, data.ru[..., None])[..., 0]
        Qt = data.Qxx[:-1] - jnp.einsum("iux,iuy->ixy", data.S, RinvS)
        qt = data.qx[:-1] - jnp.einsum("iux,iu->ix", data.S, Rinvr)
        At = data.A - jnp.einsum("ixu,iuy->ixy", data.B, RinvS)
        reduced = LQRData(
            A=At,
            B=data.B,
            c=data.c,
            Qxx=jnp.concatenate([Qt, data.Qxx[-1:]], axis=0),
            qx=jnp.concatenate([qt, data.qx[-1:]], axis=0),
            Ruu=data.Ruu,
            ru=data.ru,
        )
        dX, dUt = riccati_solve_parallel(reduced, dx0)
        dU = dUt - jnp.einsum("iuy,iy->iu", RinvS, dX[:-1])
        return dX, dU

    # Stage elements k = 0..N-1: eliminate u around u* = −R⁻¹r.
    Ruu = data.Ruu + reg * jnp.eye(data.Ruu.shape[-1], dtype=dtype)
    Rinv_r = jnp.linalg.solve(Ruu, data.ru[..., None])[..., 0]  # (N, nu)
    Rinv_Bt = jnp.linalg.solve(Ruu, jnp.swapaxes(data.B, -1, -2))  # (N, nu, nx)
    A_e = data.A
    b_e = data.c - jnp.einsum("ixu,iu->ix", data.B, Rinv_r)
    C_e = jnp.einsum("ixu,iuy->ixy", data.B, Rinv_Bt)
    J_e = data.Qxx[:-1]
    eta_e = -data.qx[:-1]

    # Terminal element: V_N only (A = 0 pins the dangling boundary state).
    A_all = jnp.concatenate([A_e, jnp.zeros((1, nx, nx), dtype)], axis=0)
    b_all = jnp.concatenate([b_e, jnp.zeros((1, nx), dtype)], axis=0)
    C_all = jnp.concatenate([C_e, jnp.zeros((1, nx, nx), dtype)], axis=0)
    J_all = jnp.concatenate([J_e, data.Qxx[-1:]], axis=0)
    eta_all = jnp.concatenate([eta_e, -data.qx[-1:]], axis=0)

    def combine(later, earlier):
        # ``associative_scan(reverse=True)`` scans the flipped sequence, so
        # the *first* argument is the later-time element — unpack accordingly
        # (verified to machine precision against riccati_solve; with the
        # arguments read in array order the result is wrong by O(1)).
        A1, b1, C1, eta1, J1 = earlier
        A2, b2, C2, eta2, J2 = later
        M = I + jnp.einsum("...xy,...yz->...xz", C1, J2)
        # D = M⁻¹ applied from the right of A2 / left-transposed for η, J
        DA1 = jnp.linalg.solve(M, A1)
        Db1 = jnp.linalg.solve(
            M, (b1 + jnp.einsum("...xy,...y->...x", C1, eta2))[..., None]
        )[..., 0]
        DC1 = jnp.linalg.solve(M, C1)
        A12 = jnp.einsum("...xy,...yz->...xz", A2, DA1)
        b12 = jnp.einsum("...xy,...y->...x", A2, Db1) + b2
        C12 = jnp.einsum(
            "...xy,...zy->...xz", jnp.einsum("...xy,...yz->...xz", A2, DC1), A2
        ) + C2
        # (I + J₂C₁)⁻¹ = M⁻ᵀ since (I + J₂C₁) = Mᵀ for symmetric C₁, J₂.
        Mt = jnp.swapaxes(M, -1, -2)
        Dt_rhs = jnp.linalg.solve(
            Mt,
            jnp.concatenate(
                [
                    (eta2 - jnp.einsum("...xy,...y->...x", J2, b1))[..., None],
                    jnp.einsum("...xy,...yz->...xz", J2, A1),
                ],
                axis=-1,
            ),
        )
        eta12 = jnp.einsum("...yx,...y->...x", A1, Dt_rhs[..., 0]) + eta1
        J12 = jnp.einsum("...yx,...yz->...xz", A1, Dt_rhs[..., 1:]) + J1
        J12 = 0.5 * (J12 + jnp.swapaxes(J12, -1, -2))
        return A12, b12, C12, eta12, J12

    suffix = jax.lax.associative_scan(
        combine, (A_all, b_all, C_all, eta_all, J_all), reverse=True, axis=0
    )
    S = suffix[4]  # (N+1, nx, nx): J of suffix k..N  → value Hessian at k
    v = suffix[3]  # (N+1, nx): η of suffix

    # Stage-parallel gain extraction against V_{k+1}(y) = ½yᵀS_{k+1}y − v_{k+1}ᵀy.
    S1, v1 = S[1:], v[1:]
    BtS = jnp.einsum("ixu,ixy->iuy", data.B, S1)
    G = Ruu + jnp.einsum("iuy,iyv->iuv", BtS, data.B)
    G = 0.5 * (G + jnp.swapaxes(G, -1, -2))
    rhs_k = data.ru + jnp.einsum(
        "iuy,iy->iu", BtS, data.c
    ) - jnp.einsum("ixu,ix->iu", data.B, v1)
    KK = -jnp.linalg.solve(G, jnp.einsum("iuy,iyz->iuz", BtS, data.A))
    kk = -jnp.linalg.solve(G, rhs_k[..., None])[..., 0]

    # Forward rollout as prefix composition of affine maps
    # x_{k+1} = (A + BK)x + (Bk + c).
    M_f = data.A + jnp.einsum("ixu,iuy->ixy", data.B, KK)
    v_f = jnp.einsum("ixu,iu->ix", data.B, kk) + data.c

    def affine_combine(f, g):
        # composition g∘f (f earlier in time)
        Mf, vf = f
        Mg, vg = g
        return (
            jnp.einsum("...xy,...yz->...xz", Mg, Mf),
            jnp.einsum("...xy,...y->...x", Mg, vf) + vg,
        )

    Mp, vp = jax.lax.associative_scan(affine_combine, (M_f, v_f), axis=0)
    dX_tail = jnp.einsum("ixy,y->ix", Mp, dx0) + vp  # states 1..N
    dX = jnp.concatenate([dx0[None], dX_tail], axis=0)
    dU = jnp.einsum("iuy,iy->iu", KK, dX[:-1]) + kk
    return dX, dU


class BoxedQPData(NamedTuple):
    """Stage-structured QP with bounds + linearized inequality constraints.

    Margins use the convention w ≥ 0 feasible. ``Jh``/``h0`` describe
    n_h linearized constraints per stage: h0ᵢ + Jhᵢ δxᵢ ≥ 0 (acados-style
    obstacle rows, mpc_differential_drive_obstacle_static.py:219-234).
    """

    A: jnp.ndarray
    B: jnp.ndarray
    c: jnp.ndarray
    Q: jnp.ndarray  # (N+1, nx, nx) LS Hessian blocks
    qx_base: jnp.ndarray  # (N+1, nx) LS gradient at δ=0
    R: jnp.ndarray  # (N, nu, nu)
    ru_base: jnp.ndarray  # (N, nu)
    lbx: jnp.ndarray  # (N+1, nx) margins offset: lbx_margin = x̄ − lbx at δ=0
    ubx: jnp.ndarray  # (N+1, nx) ubx_margin = ubx − x̄ at δ=0
    lbu: jnp.ndarray  # (N, nu)
    ubu: jnp.ndarray  # (N, nu)
    Jh: Optional[jnp.ndarray]  # (N+1, n_h, nx) or None
    h0: Optional[jnp.ndarray]  # (N+1, n_h) margins at δ=0
    S: Optional[jnp.ndarray] = None  # (N, nu, nx) LS cross blocks (JuᵀWJx)


def barrier_qp_solve(
    qp: BoxedQPData,
    dx0: jnp.ndarray,
    num_iters: int = 12,
    mu0: float = 1.0e-1,
    kappa: float = 0.35,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
    parallel: bool = False,
    return_kkt: bool = False,
):
    """Solve the inequality-constrained QP by barrier-Newton/Riccati.

    Each of ``num_iters`` iterations: evaluate relaxed-barrier derivatives at
    the current (δX, δU), fold them into the stage Hessians/gradients, and take
    one exact Riccati Newton step. μ decreases geometrically (μ ← κμ), so the
    iterate tracks the central path toward the constrained optimum — the same
    short-step IP structure as HPIPM, minus the C code.

    ``parallel`` switches the inner LQR solves to the O(log N)-depth
    associative-scan Riccati (:func:`riccati_solve_parallel`).

    ``return_kkt`` additionally returns the ∞-norm of the *last* (damped)
    Newton step — a convergence certificate: the exact Newton step length at
    the final barrier μ bounds the distance to that μ's central point, so a
    large value flags that ``num_iters`` was not enough (e.g. many active
    h-rows). Returns (δX, δU) or (δX, δU, kkt_step_norm).
    """
    N = qp.A.shape[0]
    nx = qp.A.shape[1]
    nu = qp.B.shape[2]
    dtype = qp.A.dtype
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    if h_stiffness is None:
        h_stiffness = stiffness

    def one_iter(carry, mu):
        dX, dU = carry

        # ----- barrier derivatives at current point ------------------------
        # state bounds (stages 1..N; stage 0 fixed by dx0)
        wl = qp.lbx + dX  # margin for x ≥ lbx
        wu = qp.ubx - dX
        _, gl, hl = relaxed_barrier(wl, mu, delta, stiffness)
        _, gu, hu = relaxed_barrier(wu, mu, delta, stiffness)
        # ∂w/∂δx = +1 (lower), −1 (upper)
        qx_bar = gl - gu  # (N+1, nx)
        Qxx_bar = hl + hu  # diagonal adds

        wlu = qp.lbu + dU
        wuu = qp.ubu - dU
        _, glu, hlu = relaxed_barrier(wlu, mu, delta, stiffness)
        _, guu, huu = relaxed_barrier(wuu, mu, delta, stiffness)
        ru_bar = glu - guu
        Ruu_bar = hlu + huu

        Qxx = qp.Q + jax.vmap(jnp.diag)(Qxx_bar)
        qx = qp.qx_base + jax.vmap(lambda Qi, d: Qi @ d)(qp.Q, dX) + qx_bar
        Ruu = qp.R + jax.vmap(jnp.diag)(Ruu_bar)
        ru = qp.ru_base + jax.vmap(lambda Ri, d: Ri @ d)(qp.R, dU) + ru_bar
        if qp.S is not None:
            # cross-term gradient contributions at the current iterate
            qx = qx.at[:-1].add(jnp.einsum("iuy,iu->iy", qp.S, dU))
            ru = ru + jnp.einsum("iuy,iy->iu", qp.S, dX[:-1])

        if qp.Jh is not None:
            wh = qp.h0 + jnp.einsum("ihx,ix->ih", qp.Jh, dX)
            _, gh, hh = relaxed_barrier(wh, mu, delta, h_stiffness)
            if h_slope:
                # L1 slack penalty zl·max(0, −h): the soft-constraint convention
                # of acados' zl vectors (test_diff_mpc_dyna_slack.py:178-182)
                gh = gh - h_slope * (wh < 0).astype(dtype)
            qx = qx + jnp.einsum("ihx,ih->ix", qp.Jh, gh)
            Qxx = Qxx + jnp.einsum("ihx,ih,ihy->ixy", qp.Jh, hh, qp.Jh)

        # zero out stage-0 state cost (δx₀ is fixed)
        Qxx = Qxx.at[0].set(jnp.eye(nx, dtype=dtype))
        qx = qx.at[0].set(jnp.zeros((nx,), dtype=dtype))

        # ----- Newton step: affine LQR on the residual problem --------------
        # dynamics residual of the current delta iterate
        c_res = (
            jnp.einsum("ixy,iy->ix", qp.A, dX[:-1])
            + jnp.einsum("ixy,iy->ix", qp.B, dU)
            + qp.c
            - dX[1:]
        )
        data = LQRData(
            A=qp.A, B=qp.B, c=c_res, Qxx=Qxx, qx=qx, Ruu=Ruu, ru=ru, S=qp.S
        )
        lqr = riccati_solve_parallel if parallel else riccati_solve
        ddX, ddU = lqr(data, jnp.zeros((nx,), dtype=dtype))

        # Fraction-to-boundary damping (the HPIPM step rule): constraints
        # currently in the log region must not be driven below ~δ in one step,
        # otherwise Newton ping-pongs between the wall and the interior.
        def ftb(w, dw):
            # max α with w + α·dw ≥ δ/2, for decreasing log-region margins.
            # Double-where keeps grads finite: with a single where, the
            # untaken branch's 1/1e-30 denominator turns reverse-mode
            # cotangents into 0·inf = NaN for every non-shrinking margin,
            # poisoning jax.grad through the whole solve (same values).
            shrink = (dw < 0) & (w > delta)
            denom = jnp.where(shrink, jnp.maximum(-dw, 1e-30), 1.0)
            a = jnp.where(shrink, (w - 0.5 * delta) / denom, jnp.inf)
            return jnp.min(a)

        alpha = jnp.minimum(1.0, jnp.minimum(
            jnp.minimum(ftb(wl, ddX), ftb(wu, -ddX)),
            jnp.minimum(ftb(wlu, ddU), ftb(wuu, -ddU)),
        ))
        if qp.Jh is not None:
            dwh = jnp.einsum("ihx,ix->ih", qp.Jh, ddX)
            alpha = jnp.minimum(alpha, ftb(wh, dwh))
        alpha = alpha.astype(dtype)
        step_norm = jnp.maximum(
            jnp.max(jnp.abs(alpha * ddX)), jnp.max(jnp.abs(alpha * ddU))
        )
        return (dX + alpha * ddX, dU + alpha * ddU), step_norm

    dX0 = jnp.zeros((N + 1, nx), dtype=dtype).at[0].set(dx0)
    dU0 = jnp.zeros((N, nu), dtype=dtype)
    mus = mu0 * (kappa ** jnp.arange(num_iters, dtype=dtype))
    (dX, dU), step_norms = jax.lax.scan(one_iter, (dX0, dU0), mus)

    # Condensing roll: fraction-to-boundary damping leaves a residual in the
    # *linear* dynamics; eliminate it exactly by propagating δx with the solved
    # δU (the state-elimination step of a condensed QP). The SQP outer loop
    # then only contends with genuine nonlinearity.
    if parallel:
        # prefix composition of the affine maps δx ↦ Aδx + (Bδu + c);
        # associative_scan (forward) passes (earlier, later) — compose later∘earlier
        drift = jnp.einsum("ixu,iu->ix", qp.B, dU) + qp.c
        Mp, vp = jax.lax.associative_scan(
            lambda f, g: (
                jnp.einsum("...xy,...yz->...xz", g[0], f[0]),
                jnp.einsum("...xy,...y->...x", g[0], f[1]) + g[1],
            ),
            (qp.A, drift),
            axis=0,
        )
        dX_tail = jnp.einsum("ixy,y->ix", Mp, dx0) + vp
    else:
        def roll(dx, inp):
            A, B, c, du = inp
            dx_next = A @ dx + B @ du + c
            return dx_next, dx_next

        _, dX_tail = jax.lax.scan(roll, dx0, (qp.A, qp.B, qp.c, dU))
    dX = jnp.concatenate([dx0[None], dX_tail], axis=0)
    if return_kkt:
        return dX, dU, step_norms[-1]
    return dX, dU


def condensed_barrier_objective(
    dU: jnp.ndarray,
    qp: BoxedQPData,
    dx0: jnp.ndarray,
    mu,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
) -> jnp.ndarray:
    """The condensed (state-eliminated) barrier objective J(δU; qp, δx₀, μ).

    δX is eliminated through the exact linear rollout, so ∇_{δU}J = 0 is the
    stationarity condition :func:`barrier_qp_solve`'s final iterate satisfies
    at its last barrier weight μ — the implicit function the IFT backward
    pass differentiates (ops/pallas/riccati_qp.py). Stage-0 state terms are
    excluded exactly as the solver excludes them (one_iter zeroes them; δx₀
    is data, not a decision variable).
    """
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    if h_stiffness is None:
        h_stiffness = stiffness

    def roll(dx, inp):
        A, B, c, du = inp
        nxt = A @ dx + B @ du + c
        return nxt, nxt

    _, tail = jax.lax.scan(roll, dx0, (qp.A, qp.B, qp.c, dU))
    dX = jnp.concatenate([dx0[None], tail], axis=0)

    quad = (
        0.5 * jnp.einsum("ix,ixy,iy->", dX[1:], qp.Q[1:], dX[1:])
        + jnp.einsum("ix,ix->", qp.qx_base[1:], dX[1:])
        + 0.5 * jnp.einsum("iu,iuv,iv->", dU, qp.R, dU)
        + jnp.einsum("iu,iu->", qp.ru_base, dU)
    )
    if qp.S is not None:
        quad = quad + jnp.einsum("iu,iuy,iy->", dU, qp.S, dX[:-1])

    def bsum(w, stiff):
        val, _, _ = relaxed_barrier(w, mu, delta, stiff)
        return jnp.sum(val)

    bar = (
        bsum(qp.lbx[1:] + dX[1:], stiffness)
        + bsum(qp.ubx[1:] - dX[1:], stiffness)
        + bsum(qp.lbu + dU, stiffness)
        + bsum(qp.ubu - dU, stiffness)
    )
    if qp.Jh is not None:
        wh = qp.h0[1:] + jnp.einsum("ihx,ix->ih", qp.Jh[1:], dX[1:])
        bar = bar + bsum(wh, h_stiffness)
        if h_slope:
            bar = bar + h_slope * jnp.sum(jnp.maximum(-wh, 0.0))
    return quad + bar


def barrier_hessian_blocks(
    qp: BoxedQPData,
    dX: jnp.ndarray,
    dU: jnp.ndarray,
    mu,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
):
    """Barrier-augmented stage Hessians (Q̃, R̃) at a given iterate.

    The same augmentation ``barrier_qp_solve.one_iter`` builds per Newton
    step, exposed for the IFT backward: one Riccati solve against these
    blocks applies (∇²_{δU}J)⁻¹ — the "one extra factorized solve" that
    replaces differentiating through the whole unrolled forward.
    """
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    if h_stiffness is None:
        h_stiffness = stiffness
    nx = qp.A.shape[1]
    dtype = qp.A.dtype
    _, _, hl = relaxed_barrier(qp.lbx + dX, mu, delta, stiffness)
    _, _, hu = relaxed_barrier(qp.ubx - dX, mu, delta, stiffness)
    Qxx = qp.Q + jax.vmap(jnp.diag)(hl + hu)
    _, _, hlu = relaxed_barrier(qp.lbu + dU, mu, delta, stiffness)
    _, _, huu = relaxed_barrier(qp.ubu - dU, mu, delta, stiffness)
    Ruu = qp.R + jax.vmap(jnp.diag)(hlu + huu)
    if qp.Jh is not None:
        wh = qp.h0 + jnp.einsum("ihx,ix->ih", qp.Jh, dX)
        _, _, hh = relaxed_barrier(wh, mu, delta, h_stiffness)
        Qxx = Qxx + jnp.einsum("ihx,ih,ihy->ixy", qp.Jh, hh, qp.Jh)
    Qxx = Qxx.at[0].set(jnp.eye(nx, dtype=dtype))
    return Qxx, Ruu


def ift_qp_vjp(
    qp: BoxedQPData,
    dx0: jnp.ndarray,
    dX: jnp.ndarray,
    dU: jnp.ndarray,
    ct_X: jnp.ndarray,
    ct_U: jnp.ndarray,
    num_iters: int = 12,
    mu0: float = 1.0e-1,
    kappa: float = 0.35,
    delta: float = 1.0e-3,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
):
    """Implicit-function-theorem VJP of the barrier QP at its solution.

    Output map: δU*(θ) solves ∇_{δU}J(δU; θ, μ_f) = 0 at the final barrier
    weight μ_f = μ₀·κ^{iters−1}; δX = rollout(δU*, θ). Given cotangents
    (c̄ₓ, c̄ᵤ):

      1. pull c̄ₓ through the linear rollout → direct θ̄ term + extra δU cotangent;
      2. adjoint solve y = (∇²_{δU}J)⁻¹ c̄ᵤᵗᵒᵗ — ONE Riccati factorized solve
         against the barrier-augmented stage Hessians at the solution;
      3. θ̄ −= (∂²J/∂θ∂δU)ᵀ y via one VJP of the stationarity residual.

    Cost: one Riccati solve + two VJP evaluations of a single objective
    gradient, vs. the recompute rule's reverse pass through ``num_iters``
    unrolled barrier-Newton/Riccati iterations. Exact for a converged solve
    (the kkt step-norm certificate bounds the residual); gradient parity vs
    finite differences and the recompute rule is pinned in
    tests/test_diff_nmpc.py.
    """
    dtype = qp.A.dtype
    mu_f = jnp.asarray(mu0 * (kappa ** (num_iters - 1)), dtype)
    nx = qp.A.shape[1]
    # the QP kernel solves in f32 unless the qp is f64 — align the
    # solution/cotangents with the qp so the VJPs type-check
    dX, dU = dX.astype(dtype), dU.astype(dtype)
    ct_X, ct_U = ct_X.astype(dtype), ct_U.astype(dtype)

    # 1. rollout VJP: dX = R(dU, qp, dx0)
    def rollout(dU_, qp_, dx0_):
        def roll(dx, inp):
            A, B, c, du = inp
            nxt = A @ dx + B @ du + c
            return nxt, nxt

        _, tail = jax.lax.scan(roll, dx0_, (qp_.A, qp_.B, qp_.c, dU_))
        return jnp.concatenate([dx0_[None], tail], axis=0)

    _, roll_vjp = jax.vjp(rollout, dU, qp, dx0)
    bar_dU_from_X, bar_qp_roll, bar_dx0_roll = roll_vjp(ct_X)
    ct_U_tot = ct_U + bar_dU_from_X

    # 2. adjoint solve via one Riccati sweep on the barrier-augmented blocks
    Qxx, Ruu = barrier_hessian_blocks(
        qp, dX, dU, mu_f, delta=delta, h_stiffness=h_stiffness
    )
    adj = LQRData(
        A=qp.A,
        B=qp.B,
        c=jnp.zeros_like(qp.c),
        Qxx=Qxx,
        qx=jnp.zeros((qp.A.shape[0] + 1, nx), dtype),
        Ruu=Ruu,
        ru=-ct_U_tot,
        S=qp.S,
    )
    _, y = riccati_solve(adj, jnp.zeros((nx,), dtype))

    # 3. cross-derivative VJP of the stationarity residual wrt θ at fixed δU*
    def stat_residual(qp_, dx0_):
        return jax.grad(condensed_barrier_objective)(
            dU, qp_, dx0_, mu_f, delta=delta,
            h_stiffness=h_stiffness, h_slope=h_slope,
        )

    _, g_vjp = jax.vjp(stat_residual, qp, dx0)
    bar_qp_stat, bar_dx0_stat = g_vjp(-y)

    bar_qp = jax.tree.map(
        lambda a, b: a + b if (a is not None and b is not None) else (a or b),
        bar_qp_roll,
        bar_qp_stat,
        is_leaf=lambda x: x is None,
    )
    return bar_qp, bar_dx0_roll + bar_dx0_stat


__all__ = [
    "relaxed_barrier",
    "LQRData",
    "riccati_solve",
    "BoxedQPData",
    "barrier_qp_solve",
    "condensed_barrier_objective",
    "barrier_hessian_blocks",
    "ift_qp_vjp",
]
