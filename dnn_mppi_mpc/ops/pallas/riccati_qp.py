"""Barrier-Riccati QP kernel for the GPU — a fleet of NMPC QPs in one launch.

The stage-structured barrier QP of solvers/qp.py::barrier_qp_solve is
latency-bound, not FLOP-bound: qp_iters × (backward + forward) Riccati
sweeps over N stages of 3×3/5×5 matrices are hundreds of *dependent* tiny
operations, and on the XLA path each is at least one launch. This kernel
keeps the whole solve — every Newton iteration: relaxed-barrier derivative
folds, the backward Riccati recursion, the forward rollout,
fraction-to-boundary damping, the iterate update — inside one launch
(Pallas through Triton).

Fleet members map onto threads: every "scalar" of the algorithm is a
(block_b,) vector over members, so one program solves ``block_b`` problems
with the identical sequential schedule (grid over the padded fleet beyond
that). A single solve is a fleet of one, padded. Per-stage gains and the
Newton step go to device-memory outputs between the sweeps; at these sizes
they stay in L2.

Semantics are those of ``barrier_qp_solve`` (same μ-schedule,
regularization, damping rule and final condensing roll); parity-tested in
tests/test_riccati_qp.py, including the h-constraint and cross-term (S)
paths. Replaces acados' FULL_CONDENSING_HPIPM step
(mpc_differential_drive_obstacle_static.py:237) at the kernel level.

All matrices are small and static (nx, nu, n_h ≤ ~8): loops over matrix
dimensions are Python-unrolled into straight-line code; loops over stages
and Newton iterations are ``fori_loop``s with dynamic indexing on the stage
dimension. Stage-stacked inputs are flattened to (stage, row·col, member)
tables with the member index contiguous.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.custom_batching import custom_vmap
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_INF = 3.0e38
BLOCK_B = 32  # fleet members per grid program (one per thread of a warp)


def _qp_kernel(
    mus_ref,  # (num_iters,) barrier μ schedule (shared across members)
    misc_ref,  # (5,) δ, κ_bound, κ_h, h_slope, reg (shared)
    A_ref,  # (N, nx·nx, Bp)
    B_ref,  # (N, nx·nu, Bp)
    c_ref,  # (N, nx, Bp)
    Q_ref,  # (N+1, nx·nx, Bp)
    qxb_ref,  # (N+1, nx, Bp)
    R_ref,  # (N, nu·nu, Bp)
    rub_ref,  # (N, nu, Bp)
    lbx_ref,  # (N+1, nx, Bp) margins at δ=0
    ubx_ref,  # (N+1, nx, Bp)
    lbu_ref,  # (N, nu, Bp)
    ubu_ref,  # (N, nu, Bp)
    Jh_ref,  # (N+1, n_h·nx, Bp) (dummy (1, 1, Bp) when n_h=0)
    h0_ref,  # (N+1, n_h, Bp)
    S_ref,  # (N, nu·nx, Bp) (dummy when has_S=False)
    dx0_ref,  # (1, nx, Bp)
    dX_ref,  # out (N+1, nx, Bp)
    dU_ref,  # out (N, nu, Bp)
    kkt_ref,  # out (1, 1, Bp)
    K_s,  # out, work (N, nu·nx, Bp) feedback gains
    k_s,  # out, work (N, nu, Bp)
    ddX_s,  # out, work (N+1, nx, Bp) Newton step
    ddU_s,  # out, work (N, nu, Bp)
    cres_s,  # out, work (N, nx, Bp) dynamics residual at the iterate
    *,
    N: int,
    nx: int,
    nu: int,
    n_h: int,
    num_iters: int,
    has_S: bool,
    block_b: int,
    dtype,
):
    f32 = jnp.dtype(dtype).type  # the solve's float type (f32; f64 under x64)
    # Element access: one (block_b,) vector over fleet members per
    # algorithmic "scalar". The algorithm below is written once against
    # these primitives.
    members = pl.ds(pl.program_id(0) * block_b, block_b)

    def ld(ref, i, j):
        return ref[i, j, members]

    def st(ref, i, j, v):
        ref[i, j, members] = v

    def ld1(ref, i):
        return ref[0, i, members]

    def st1(ref, i, v):
        ref[0, i, members] = v

    def const(x):
        return jnp.full((block_b,), x, dtype)

    delta = misc_ref[0]
    stiff = misc_ref[1]
    h_stiff = misc_ref[2]
    h_slope = misc_ref[3]
    reg = misc_ref[4]

    def rb(w, mu, kappa):
        """(ψ', ψ'') of the relaxed log barrier (solvers/qp.py::relaxed_barrier)."""
        use_log = w > delta
        w_safe = jnp.maximum(w, delta)
        g = jnp.where(use_log, -mu / w_safe, -mu / delta - kappa * (delta - w))
        h = jnp.where(use_log, mu / (w_safe * w_safe), kappa)
        return g, h

    def lu_solve(M, rhs_cols):
        """Solve M X = rhs for unrolled M (nu×nu nested lists) via
        partial-pivot LU; rhs is a list of columns (each a list of nu
        elements). Returns list of columns. Pivoted LU rather than Cholesky:
        f32 cancellation under barrier stiffness can leave Luu indefinite,
        where Cholesky pivot clamping explodes the gain but LU returns the
        same bounded step as jnp.linalg.solve (see
        ops/sampling.py::small_lu_solve). In the batched kernel the pivot
        choice is per member (each fleet member pivots independently)."""
        m = len(rhs_cols)
        w = nu + m
        rows = [
            [M[i][j] for j in range(nu)] + [col[i] for col in rhs_cols]
            for i in range(nu)
        ]
        for i in range(nu):
            # bubble the max-|column i| row into position i
            for j in range(i + 1, nu):
                swap = jnp.abs(rows[j][i]) > jnp.abs(rows[i][i])
                for t in range(w):
                    hi = jnp.where(swap, rows[j][t], rows[i][t])
                    lo = jnp.where(swap, rows[i][t], rows[j][t])
                    rows[i][t], rows[j][t] = hi, lo
            inv_p = f32(1.0) / rows[i][i]
            for j in range(i + 1, nu):
                f = rows[j][i] * inv_p
                for t in range(i, w):
                    rows[j][t] = rows[j][t] - f * rows[i][t]
        out = []
        for ci in range(m):
            x = [None] * nu
            for i in reversed(range(nu)):
                s = rows[i][nu + ci]
                for t in range(i + 1, nu):
                    s = s - rows[i][t] * x[t]
                x[i] = s / rows[i][i]
            out.append(x)
        return out

    def load_mat(ref, i, rows, cols):
        return [[ld(ref, i, r * cols + c) for c in range(cols)] for r in range(rows)]

    def fold_x(i, mu):
        """Folded state Hessian/gradient at stage i for the current iterate:
        Q + barrier diag + Jhᵀ·h''·Jh ;  qx_base + Q·δx + barrier + Jhᵀ·h'."""
        dXi = [ld(dX_ref, i, d) for d in range(nx)]
        Qxx = load_mat(Q_ref, i, nx, nx)
        qx = [
            ld(qxb_ref, i, d) + sum(Qxx[d][e] * dXi[e] for e in range(nx))
            for d in range(nx)
        ]
        for d in range(nx):
            wl = ld(lbx_ref, i, d) + dXi[d]
            wu = ld(ubx_ref, i, d) - dXi[d]
            gl, hl = rb(wl, mu, stiff)
            gu, hu = rb(wu, mu, stiff)
            qx[d] = qx[d] + gl - gu
            Qxx[d][d] = Qxx[d][d] + hl + hu
        for r in range(n_h):
            Jr = [ld(Jh_ref, i, r * nx + d) for d in range(nx)]
            wh = ld(h0_ref, i, r) + sum(Jr[d] * dXi[d] for d in range(nx))
            gh, hh = rb(wh, mu, h_stiff)
            gh = gh - h_slope * jnp.where(wh < 0, f32(1.0), f32(0.0))
            for d in range(nx):
                qx[d] = qx[d] + Jr[d] * gh
                for e in range(nx):
                    Qxx[d][e] = Qxx[d][e] + Jr[d] * hh * Jr[e]
        return Qxx, qx, dXi

    def newton_iter(it, _):
        mu = mus_ref[it]

        # ---- terminal value function --------------------------------------
        QxxN, qxN, _ = fold_x(N, mu)
        P = QxxN
        p = qxN

        # ---- backward sweep ------------------------------------------------
        def backward(j, carry):
            i = N - 1 - j
            Pf = [[carry[r * nx + c] for c in range(nx)] for r in range(nx)]
            pf = [carry[nx * nx + r] for r in range(nx)]

            Qxx, qx, dXi = fold_x(i, mu)
            dUi = [ld(dU_ref, i, a) for a in range(nu)]
            Ruu = load_mat(R_ref, i, nu, nu)
            ru = [
                ld(rub_ref, i, a) + sum(Ruu[a][b] * dUi[b] for b in range(nu))
                for a in range(nu)
            ]
            for a in range(nu):
                wl = ld(lbu_ref, i, a) + dUi[a]
                wu = ld(ubu_ref, i, a) - dUi[a]
                gl, hl = rb(wl, mu, stiff)
                gu, hu = rb(wu, mu, stiff)
                ru[a] = ru[a] + gl - gu
                Ruu[a][a] = Ruu[a][a] + hl + hu
            if has_S:
                Sm = load_mat(S_ref, i, nu, nx)
                for d in range(nx):
                    qx[d] = qx[d] + sum(Sm[a][d] * dUi[a] for a in range(nu))
                for a in range(nu):
                    ru[a] = ru[a] + sum(Sm[a][d] * dXi[d] for d in range(nx))
            else:
                Sm = [[f32(0.0)] * nx for _ in range(nu)]

            Am = load_mat(A_ref, i, nx, nx)
            Bm = load_mat(B_ref, i, nx, nu)
            cres = [
                sum(Am[d][e] * dXi[e] for e in range(nx))
                + sum(Bm[d][a] * dUi[a] for a in range(nu))
                + ld(c_ref, i, d)
                - ld(dX_ref, i + 1, d)
                for d in range(nx)
            ]
            for d in range(nx):
                st(cres_s, i, d, cres[d])

            PA = [
                [sum(Pf[r][e] * Am[e][c] for e in range(nx)) for c in range(nx)]
                for r in range(nx)
            ]
            PB = [
                [sum(Pf[r][e] * Bm[e][a] for e in range(nx)) for a in range(nu)]
                for r in range(nx)
            ]
            Pc = [sum(Pf[r][e] * cres[e] for e in range(nx)) for r in range(nx)]

            Luu_raw = [
                [
                    Ruu[a][b] + sum(Bm[r][a] * PB[r][b] for r in range(nx))
                    for b in range(nu)
                ]
                for a in range(nu)
            ]
            Luu = [
                [
                    0.5 * (Luu_raw[a][b] + Luu_raw[b][a])
                    + (reg if a == b else f32(0.0))
                    for b in range(nu)
                ]
                for a in range(nu)
            ]
            Lux = [
                [
                    Sm[a][c] + sum(Bm[r][a] * PA[r][c] for r in range(nx))
                    for c in range(nx)
                ]
                for a in range(nu)
            ]
            lu = [
                ru[a] + sum(Bm[r][a] * (pf[r] + Pc[r]) for r in range(nx))
                for a in range(nu)
            ]

            cols = [[Lux[a][c] for a in range(nu)] for c in range(nx)]
            cols.append(lu)
            sol = lu_solve(Luu, cols)
            Kg = [[-sol[c][a] for c in range(nx)] for a in range(nu)]  # (nu, nx)
            kg = [-sol[nx][a] for a in range(nu)]
            for a in range(nu):
                st(k_s, i, a, kg[a])
                for c in range(nx):
                    st(K_s, i, a * nx + c, Kg[a][c])

            Pn_raw = [
                [
                    Qxx[r][c]
                    + sum(Am[e][r] * PA[e][c] for e in range(nx))
                    + sum(Lux[a][r] * Kg[a][c] for a in range(nu))
                    for c in range(nx)
                ]
                for r in range(nx)
            ]
            pn = [
                qx[r]
                + sum(Am[e][r] * (pf[e] + Pc[e]) for e in range(nx))
                + sum(Lux[a][r] * kg[a] for a in range(nu))
                for r in range(nx)
            ]
            flat = []
            for r in range(nx):
                for c in range(nx):
                    flat.append(0.5 * (Pn_raw[r][c] + Pn_raw[c][r]))
            flat.extend(pn)
            return tuple(flat)

        init = []
        for r in range(nx):
            for c in range(nx):
                init.append(P[r][c])
        init.extend(p)
        jax.lax.fori_loop(0, N, backward, tuple(init))

        # ---- forward sweep (residual problem: ddx₀ = 0) --------------------
        for d in range(nx):
            st(ddX_s, 0, d, const(0.0))

        def forward(i, carry):
            ddx = list(carry)
            ddu = [
                ld(k_s, i, a)
                + sum(ld(K_s, i, a * nx + c) * ddx[c] for c in range(nx))
                for a in range(nu)
            ]
            for a in range(nu):
                st(ddU_s, i, a, ddu[a])
            Am = load_mat(A_ref, i, nx, nx)
            Bm = load_mat(B_ref, i, nx, nu)
            nxt = [
                sum(Am[d][e] * ddx[e] for e in range(nx))
                + sum(Bm[d][a] * ddu[a] for a in range(nu))
                + ld(cres_s, i, d)
                for d in range(nx)
            ]
            for d in range(nx):
                st(ddX_s, i + 1, d, nxt[d])
            return tuple(nxt)

        jax.lax.fori_loop(0, N, forward, tuple(const(0.0) for _ in range(nx)))

        # ---- fraction-to-boundary damping ---------------------------------
        def ftb(w, dw, amin):
            shrink = jnp.logical_and(dw < 0, w > delta)
            a = jnp.where(
                shrink, (w - 0.5 * delta) / jnp.maximum(-dw, f32(1e-30)), f32(_INF)
            )
            return jnp.minimum(amin, a)

        def alpha_x(i, amin):
            for d in range(nx):
                dxv = ld(dX_ref, i, d)
                ddv = ld(ddX_s, i, d)
                amin = ftb(ld(lbx_ref, i, d) + dxv, ddv, amin)
                amin = ftb(ld(ubx_ref, i, d) - dxv, -ddv, amin)
            for r in range(n_h):
                wh = ld(h0_ref, i, r)
                dwh = const(0.0)
                for d in range(nx):
                    wh = wh + ld(Jh_ref, i, r * nx + d) * ld(dX_ref, i, d)
                    dwh = dwh + ld(Jh_ref, i, r * nx + d) * ld(ddX_s, i, d)
                amin = ftb(wh, dwh, amin)
            return amin

        def alpha_u(i, amin):
            for a in range(nu):
                duv = ld(dU_ref, i, a)
                ddv = ld(ddU_s, i, a)
                amin = ftb(ld(lbu_ref, i, a) + duv, ddv, amin)
                amin = ftb(ld(ubu_ref, i, a) - duv, -ddv, amin)
            return amin

        amin = jax.lax.fori_loop(0, N + 1, alpha_x, const(_INF))
        amin = jax.lax.fori_loop(0, N, alpha_u, amin)
        alpha = jnp.minimum(f32(1.0), amin)

        # ---- update + step norm -------------------------------------------
        def update(i, mx):
            for d in range(nx):
                s = alpha * ld(ddX_s, i, d)
                st(dX_ref, i, d, ld(dX_ref, i, d) + s)
                mx = jnp.maximum(mx, jnp.abs(s))
            return mx

        def update_u(i, mx):
            for a in range(nu):
                s = alpha * ld(ddU_s, i, a)
                st(dU_ref, i, a, ld(dU_ref, i, a) + s)
                mx = jnp.maximum(mx, jnp.abs(s))
            return mx

        mx = jax.lax.fori_loop(0, N + 1, update, const(0.0))
        mx = jax.lax.fori_loop(0, N, update_u, mx)
        st1(kkt_ref, 0, mx)
        return None

    # initial iterate: δX = 0 except δx₀ = dx0, δU = 0
    for d in range(nx):
        st(dX_ref, 0, d, ld1(dx0_ref, d))

    def zero_x(i, _):
        for d in range(nx):
            st(dX_ref, i + 1, d, const(0.0))
        return None

    def zero_u(i, _):
        for a in range(nu):
            st(dU_ref, i, a, const(0.0))
        return None

    jax.lax.fori_loop(0, N, zero_x, None)
    jax.lax.fori_loop(0, N, zero_u, None)

    jax.lax.fori_loop(0, num_iters, newton_iter, None)

    # ---- condensing roll: exact linear-dynamics propagation of δU ---------
    def roll(i, carry):
        dx = list(carry)
        Am = load_mat(A_ref, i, nx, nx)
        Bm = load_mat(B_ref, i, nx, nu)
        nxt = [
            sum(Am[d][e] * dx[e] for e in range(nx))
            + sum(Bm[d][a] * ld(dU_ref, i, a) for a in range(nu))
            + ld(c_ref, i, d)
            for d in range(nx)
        ]
        for d in range(nx):
            st(dX_ref, i + 1, d, nxt[d])
        return tuple(nxt)

    jax.lax.fori_loop(
        0, N, roll, tuple(ld1(dx0_ref, d) for d in range(nx))
    )


def _mu_schedule(num_iters, mu0, kappa, f=jnp.float32):
    return (f(mu0) * (f(kappa) ** jnp.arange(num_iters, dtype=f))).astype(f)


def _misc(delta, stiffness, h_stiffness, h_slope, f=jnp.float32):
    if stiffness is None:
        stiffness = 1.0 / (delta * delta)
    if h_stiffness is None:
        h_stiffness = stiffness
    return jnp.stack(
        [
            jnp.asarray(delta, f),
            jnp.asarray(stiffness, f),
            jnp.asarray(h_stiffness, f),
            jnp.asarray(h_slope, f),
            jnp.asarray(1e-9, f),  # Luu regularization (barrier_qp_solve)
        ]
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_iters", "interpret"),
)
def pallas_batched_barrier_qp_solve(
    qp,  # BoxedQPData with a leading fleet dim B on every present leaf
    dx0: jnp.ndarray,  # (B, nx)
    num_iters: int = 12,
    mu0: float = 1.0e-1,
    kappa: float = 0.35,
    delta: float = 1.0e-3,
    stiffness: Optional[float] = None,
    h_stiffness: Optional[float] = None,
    h_slope: float = 0.0,
    *,
    interpret: bool = False,
):
    """Fleet QP solve: B independent problems, one member per thread.
    Returns (δX (B,N+1,nx), δU (B,N,nu), kkt (B,)); member b's result is
    ``barrier_qp_solve`` on member b's problem."""
    Bf = dx0.shape[0]
    N, nx = qp.A.shape[1], qp.A.shape[2]
    nu = qp.B.shape[3]
    n_h = qp.Jh.shape[2] if qp.Jh is not None else 0
    has_S = qp.S is not None

    # f32 on the hot path; f64 when the problem is f64 (x64 parity checks)
    f = jnp.float64 if qp.A.dtype == jnp.float64 else jnp.float32
    mus = _mu_schedule(num_iters, mu0, kappa, f)
    misc = _misc(delta, stiffness, h_stiffness, h_slope, f)
    block_b = BLOCK_B
    Bp = -(-Bf // block_b) * block_b

    def prep(a, rows):
        """(B, rows, ...) → (rows, row·col, Bp), members contiguous; padded
        by replicating the last member (a well-conditioned problem whose
        result is discarded)."""
        a = a.astype(f).reshape(Bf, rows, -1)
        if Bp != Bf:
            pad = jnp.broadcast_to(a[-1:], (Bp - Bf,) + a.shape[1:])
            a = jnp.concatenate([a, pad], axis=0)
        return jnp.transpose(a, (1, 2, 0))

    dummy = jnp.zeros((1, 1, Bp), f)
    Jh = prep(qp.Jh, N + 1) if qp.Jh is not None else dummy
    h0 = prep(qp.h0, N + 1) if qp.h0 is not None else dummy
    S = prep(qp.S, N) if has_S else dummy

    kernel = functools.partial(
        _qp_kernel,
        N=N,
        nx=nx,
        nu=nu,
        n_h=n_h,
        num_iters=num_iters,
        has_S=has_S,
        block_b=block_b,
        dtype=f,
    )
    shapes = [
        (N + 1, nx),  # δX
        (N, nu),  # δU
        (1, 1),  # kkt
        (N, nu * nx),  # gains K
        (N, nu),  # feedforward k
        (N + 1, nx),  # Newton step δδX
        (N, nu),  # Newton step δδU
        (N, nx),  # dynamics residual
    ]
    dX, dU, kkt, *_ = pl.pallas_call(
        kernel,
        out_shape=tuple(jax.ShapeDtypeStruct(s + (Bp,), f) for s in shapes),
        grid=(Bp // block_b,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="riccati_qp",
    )(
        mus,
        misc,
        prep(qp.A, N),
        prep(qp.B, N),
        prep(qp.c, N),
        prep(qp.Q, N + 1),
        prep(qp.qx_base, N + 1),
        prep(qp.R, N),
        prep(qp.ru_base, N),
        prep(qp.lbx, N + 1),
        prep(qp.ubx, N + 1),
        prep(qp.lbu, N),
        prep(qp.ubu, N),
        Jh,
        h0,
        S,
        prep(dx0, 1),
    )
    return (
        jnp.transpose(dX, (2, 0, 1))[:Bf],
        jnp.transpose(dU, (2, 0, 1))[:Bf],
        kkt[0, 0, :Bf],
    )


def pallas_barrier_qp_solve(qp, dx0, **kw):
    """One QP through the fleet kernel (a fleet of one): (δX (N+1,nx),
    δU (N,nu), kkt ())."""
    dX, dU, kkt = pallas_batched_barrier_qp_solve(
        jax.tree.map(lambda a: a[None], qp), dx0[None], **kw
    )
    return dX[0], dU[0], kkt[0]


@functools.lru_cache(maxsize=None)
def make_vmappable_pallas_qp(
    num_iters: int,
    mu0: float,
    kappa: float,
    h_stiffness: Optional[float],
    h_slope: float,
    interpret: bool,
    backward: str = "ift",
    delta: float = 1.0e-3,
):
    """The QP kernel as a ``custom_vmap``- and ``custom_vjp``-wrapped
    callable.

    An unbatched call is a fleet of one; under ``vmap``
    (NMPCSolver.batched_solve fleets) the batch rule hands the whole fleet to
    the kernel — one launch, members on threads, rather than a fall-back to
    the XLA Riccati path.

    Differentiation: a Pallas kernel has no autodiff rule; two backward
    modes are provided (round-2 verdict #7):

    * ``backward="ift"`` (default) — implicit-function-theorem VJP at the
      solution (solvers.qp.ift_qp_vjp): ONE extra Riccati factorized solve
      against the barrier-augmented Hessians plus two objective-gradient
      VJPs, instead of reverse-mode through the whole unrolled forward.
      Exact for a converged solve; the kkt output gets zero cotangent (it
      is a convergence certificate, not a differentiable quantity).
    * ``backward="recompute"`` — re-runs the XLA ``barrier_qp_solve`` (the
      same algorithm, parity-tested in tests/test_riccati_qp.py) and pulls
      the cotangent through that graph: the exact gradient of the
      *algorithm*, at ~num_iters× the backward cost.

    Forward stays at kernel speed either way. Cached per static config so
    repeated traces share the wrapper."""
    kw = dict(
        num_iters=num_iters,
        mu0=mu0,
        kappa=kappa,
        h_stiffness=h_stiffness,
        h_slope=h_slope,
        delta=delta,
    )

    @custom_vmap
    def _primal(qp, dx0):
        return pallas_barrier_qp_solve(qp, dx0, interpret=interpret, **kw)

    @_primal.def_vmap
    def _batched_rule(axis_size, in_batched, qp, dx0):
        qp_flags, dx0_flag = in_batched

        def bcast(leaf, flag):
            return leaf if flag else jnp.broadcast_to(leaf, (axis_size,) + leaf.shape)

        qp_b = jax.tree.map(bcast, qp, qp_flags)
        dx0_b = bcast(dx0, dx0_flag)
        out = pallas_batched_barrier_qp_solve(qp_b, dx0_b, interpret=interpret, **kw)
        return out, (True, True, True)

    @jax.custom_vjp
    def solve(qp, dx0):
        return _primal(qp, dx0)

    if backward == "ift":

        def _fwd(qp, dx0):
            out = _primal(qp, dx0)
            # residuals: inputs + the solution itself (IFT differentiates
            # the stationarity condition AT the solution — no recompute)
            return out, (qp, dx0, out[0], out[1])

        def _bwd(res, ct):
            qp, dx0, dX, dU = res
            ct_X, ct_U, _ct_kkt = ct  # kkt: certificate only, no gradient
            from ...solvers.qp import ift_qp_vjp  # local: avoid import cycle

            return ift_qp_vjp(
                qp, dx0, dX, dU, ct_X, ct_U,
                num_iters=num_iters, mu0=mu0, kappa=kappa,
                h_stiffness=h_stiffness, h_slope=h_slope,
            )

    else:  # "recompute"

        def _fwd(qp, dx0):
            return _primal(qp, dx0), (qp, dx0)

        def _bwd(res, ct):
            qp, dx0 = res
            from ...solvers.qp import barrier_qp_solve  # avoid import cycle

            def xla_solve(qp_, dx0_):
                return barrier_qp_solve(qp_, dx0_, return_kkt=True, **kw)

            _, vjp = jax.vjp(xla_solve, qp, dx0)
            # kernel outputs are f32 regardless of qp dtype — align cotangents
            ct = tuple(c.astype(qp.A.dtype) for c in ct)
            return vjp(ct)

    solve.defvjp(_fwd, _bwd)
    return solve


__all__ = [
    "BLOCK_B",
    "pallas_barrier_qp_solve",
    "pallas_batched_barrier_qp_solve",
    "make_vmappable_pallas_qp",
]
