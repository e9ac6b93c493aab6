"""SQP-RTI NMPC engine — jitted Gauss-Newton SQP over multiple shooting.

JAX replacement for the whole acados pipeline (SURVEY §2.2, §2.9):
AcadosModel/AcadosOcp assembly → here a :class:`OCPFunctions` bundle of pure
functions; codegen + HPIPM → a jitted solve built from ``jax.jacfwd``
linearization and the Riccati barrier QP of :mod:`.qp`. Semantics mirrored:

* LINEAR_LS cost y=(x,u), W=blkdiag(Q,R), yref per stage + terminal Qe
  (mpc_differential_drive_obstacle_static.py:169-193)
* ERK discretization, 4 stages × 3 substeps (…:241-242)
* SQP_RTI: one Gauss-Newton linearization + one QP per tick, warm-started from
  the previous trajectory (…:240, :313-317); sqp_iters>1 gives the converged
  SQP of the pure-CasADi/IPOPT controller (mpc_racecar_casadi.py:89-123)
* box state/control bounds (…:197-209), obstacle h-constraints with per-stage
  parameters (…:211-234), soft-constraint slack penalties
  (test_diff_mpc_dyna_slack.py:158-182) via the relaxed barrier + optional
  explicit L1/L2 penalty
* learned-dynamics NMPC: pass residual dynamics (models.dynamics.residual_dynamics);
  jacfwd differentiates through the network in-graph, replacing the l4casadi
  shared-library path (…:249-252, simulation/bullet_differential_drive_dnn.py:288-317).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ..config import SQPConfig
from ..models.integrators import erk_step
from ..utils.platform import platform
from .qp import BoxedQPData, barrier_qp_solve


@register_pytree_node_class
@dataclasses.dataclass
class OCPParams:
    """Runtime OCP data (pytree): cost matrices, references, bounds, h params.

    ``yref`` stacks (x_ref, u_ref) rows like acados' ny=(nx+nu) reference
    (mpc_differential_drive_obstacle_static.py:182); ``p`` feeds the
    h-constraint function (obstacle positions/radii, …:302-306).
    """

    Q: jnp.ndarray  # (nx, nx)
    R: jnp.ndarray  # (nu, nu)
    Qe: jnp.ndarray  # (nx, nx)
    yref: jnp.ndarray  # (N, nx + nu)
    yref_e: jnp.ndarray  # (nx,)
    lbx: jnp.ndarray  # (nx,)
    ubx: jnp.ndarray
    lbu: jnp.ndarray  # (nu,)
    ubu: jnp.ndarray
    p: Optional[jnp.ndarray] = None  # h-constraint parameters

    def tree_flatten(self):
        return (
            self.Q,
            self.R,
            self.Qe,
            self.yref,
            self.yref_e,
            self.lbx,
            self.ubx,
            self.lbu,
            self.ubu,
            self.p,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@register_pytree_node_class
@dataclasses.dataclass
class NMPCState:
    """Warm-start trajectory carried between ticks (solve_mpc's simX/simU)."""

    X: jnp.ndarray  # (N+1, nx)
    U: jnp.ndarray  # (N, nu)

    def tree_flatten(self):
        return (self.X, self.U), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def init(cls, cfg: SQPConfig, x0: jnp.ndarray) -> "NMPCState":
        X = jnp.broadcast_to(x0, (cfg.N + 1,) + x0.shape).astype(jnp.float32)
        U = jnp.zeros((cfg.N, cfg.dim_u), dtype=jnp.float32)
        return cls(X=X, U=U)


class NMPCAux(NamedTuple):
    X: jnp.ndarray  # predicted state trajectory
    U: jnp.ndarray  # planned controls
    h_margin: jnp.ndarray  # min h-constraint margin over the horizon
    defect: jnp.ndarray  # max multiple-shooting defect after the solve
    status: jnp.ndarray  # int32: 0 ok, 2 non-finite detected (solve rejected,
    # warm start held — the solver-status handling of SURVEY §5.3, replacing
    # acados' status codes at husky_nmpc_controller.py:306-309)
    kkt_residual: jnp.ndarray  # ∞-norm of the last damped
    # Newton step of the final QP solve — a convergence certificate for the
    # fixed qp_iters μ-schedule: large values mean the barrier solve did not
    # reach its central point (raise cfg.qp_iters). Replaces acados' qp_stat.


# h(x, p) -> (n_h,), feasible iff h ≥ 0 (lh already folded in).
HFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def circle_obstacle_h(x: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """acados-style obstacle rows: (x−ox)² + (y−oy)² − (r+safe)² ≥ 0.

    ``p`` is (n_obs, 3): (ox, oy, r+safe_distance) — the per-stage parameter
    vector of mpc_differential_drive_obstacle_static.py:219-234.
    """
    d2 = jnp.sum((x[:2][None, :] - p[:, :2]) ** 2, axis=-1)
    return d2 - p[:, 2] ** 2


def _linearize(dyn_step, X, U):
    """Stage-wise A, B, defect c via vmapped jacfwd through the integrator —
    the ERK sensitivity propagation acados does in generated C.

    One combined jacfwd over the concatenated (x, u) input with the primal as
    aux: a single forward pass yields F, A and B together (three separate
    evaluations would triple the network cost on learned dynamics).
    """
    nx = X.shape[-1]

    def fval(z):
        out = dyn_step(z[:nx], z[nx:])
        return out, out

    Z = jnp.concatenate([X[:-1], U], axis=-1)
    J, F = jax.vmap(jax.jacfwd(fval, has_aux=True))(Z)
    A, B = J[..., :nx], J[..., nx:]
    c = F - X[1:]
    return A, B, c


def sqp_solve(
    cfg: SQPConfig,
    dyn_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    h_fn: Optional[HFn],
    params: OCPParams,
    state: NMPCState,
    x0: jnp.ndarray,
    y_x_fn: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    y_fn: Optional[Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]] = None,
    y_e_fn: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    qp_interpret: bool = False,
) -> Tuple[jnp.ndarray, NMPCState, NMPCAux]:
    """One NMPC tick: ``sqp_iters`` × (linearize → barrier-Riccati QP → update).

    Every matrix product of the tick runs at full f32 precision: they are
    tiny and latency-bound, and TF32 (a GPU's default for f32 products)
    would cost the QP its parity with the f64 oracles. ``qp_interpret`` runs
    the QP kernel (``qp_backend="pallas"``) in the Pallas interpreter.

    Returns (u0, warm-started state, aux). Mirrors solve_mpc
    (mpc_differential_drive_obstacle_static.py:280-331): set x0, set p/yref,
    warm start from previous trajectory, solve, read back X/U.

    Cost forms (acados cost-module parity):
    * default — LINEAR_LS with y = (x, u)
      (mpc_differential_drive_obstacle_static.py:169-193);
    * ``y_x_fn(x)`` — separable NONLINEAR_LS state residual;
    * ``y_fn(x, u)`` — general NONLINEAR_LS over (x, u), acados'
      ``cost_y_expr`` (…:186-190): full Gauss-Newton blocks including the
      cross term S = JuᵀQJx threaded through the Riccati solve. The terminal
      residual is ``y_e_fn(x)`` (defaults to ``y_fn(x, 0)``), acados'
      ``cost_y_expr_e``.
    """
    with jax.default_matmul_precision("highest"):
        nx, nu, N = cfg.dim_x, cfg.dim_u, cfg.N
        dtype = state.X.dtype
        x0 = x0.astype(dtype)
        params = jax.tree.map(
            lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a,
            params,
        )

        if y_fn is not None and y_e_fn is None:
            y_e_fn = lambda x: y_fn(x, jnp.zeros((nu,), dtype=x.dtype))

        def one_sqp_iter(carry, _):
            X, U = carry
            A, B, c = _linearize(dyn_step, X, U)
            S_cross = None

            if y_fn is not None:
                # General NONLINEAR_LS over (x, u): GN blocks from the stacked
                # Jacobian J = [Jx Ju] — Q = JxᵀWJx, R = JuᵀWJu, S = JuᵀWJx.
                def y_and_jac(x, u):
                    z = jnp.concatenate([x, u])
                    J, y = jax.jacfwd(
                        lambda zz: (y_fn(zz[:nx], zz[nx:]), y_fn(zz[:nx], zz[nx:])),
                        has_aux=True,
                    )(z)
                    return J[..., :nx], J[..., nx:], y

                Jx, Ju, Y = jax.vmap(y_and_jac)(X[:-1], U)  # (N, ny, ·)
                ny = Y.shape[-1]
                r_stage = Y - params.yref[:, :ny]
                Je, Ye = jax.jacfwd(lambda x: (y_e_fn(x), y_e_fn(x)), has_aux=True)(X[-1])
                r_term = Ye - params.yref_e
                Qs = jnp.concatenate(
                    [
                        jnp.einsum("iax,ab,iby->ixy", Jx, params.Q, Jx),
                        jnp.einsum("ax,ab,by->xy", Je, params.Qe, Je)[None],
                    ],
                    axis=0,
                )
                qx_base = jnp.concatenate(
                    [
                        jnp.einsum("iax,ab,ib->ix", Jx, params.Q, r_stage),
                        jnp.einsum("ax,ab,b->x", Je, params.Qe, r_term)[None],
                    ],
                    axis=0,
                )
                # In this mode params.Q is the full W (ny × ny) over the residual
                # (include u-rows in y for control cost, as acados' y_expr does).
                Rs = jnp.einsum("iau,ab,ibv->iuv", Ju, params.Q, Ju)
                ru_base = jnp.einsum("iau,ab,ib->iu", Ju, params.Q, r_stage)
                S_cross = jnp.einsum("iau,ab,ibx->iux", Ju, params.Q, Jx)
            elif y_x_fn is None:
                # LINEAR_LS Gauss-Newton blocks: Hessian = blkdiag(Q, R) exactly.
                Qs = jnp.concatenate(
                    [jnp.broadcast_to(params.Q, (N, nx, nx)), params.Qe[None]], axis=0
                )
                qx_base = jnp.concatenate(
                    [
                        jnp.einsum("xy,iy->ix", params.Q, X[:-1] - params.yref[:, :nx]),
                        (params.Qe @ (X[-1] - params.yref_e))[None],
                    ],
                    axis=0,
                )
            else:
                # NONLINEAR_LS with a state-residual expression y_x(x) — the
                # separable form of acados' cost_y_expr (the reference always uses
                # y = vertcat(x, u), mpc_differential_drive_obstacle_static.py:188;
                # y_x generalizes the state part): GN Hessian JᵀQJ, gradient JᵀQr.
                def y_and_jac(x):
                    J, y = jax.jacfwd(lambda s: (y_x_fn(s), y_x_fn(s)), has_aux=True)(x)
                    return J, y

                Jy, Y = jax.vmap(y_and_jac)(X)  # (N+1, ny, nx), (N+1, ny)
                r_stage = Y[:-1] - params.yref[:, : Y.shape[-1]]
                r_term = Y[-1] - params.yref_e
                Qs = jnp.concatenate(
                    [
                        jnp.einsum("iax,ab,iby->ixy", Jy[:-1], params.Q, Jy[:-1]),
                        jnp.einsum("ax,ab,by->xy", Jy[-1], params.Qe, Jy[-1])[None],
                    ],
                    axis=0,
                )
                qx_base = jnp.concatenate(
                    [
                        jnp.einsum("iax,ab,ib->ix", Jy[:-1], params.Q, r_stage),
                        jnp.einsum("ax,ab,b->x", Jy[-1], params.Qe, r_term)[None],
                    ],
                    axis=0,
                )
            if y_fn is None:
                Rs = jnp.broadcast_to(params.R, (N, nu, nu))
                # control reference = trailing nu columns of yref (identical to the
                # [:, nx:] slice in the LINEAR_LS case where y = (x, u))
                ru_base = jnp.einsum("uv,iv->iu", params.R, U - params.yref[:, -nu:])

            if h_fn is not None and params.p is not None:
                h0 = jax.vmap(lambda x: h_fn(x, params.p))(X)  # (N+1, n_h)
                Jh = jax.vmap(jax.jacfwd(lambda x: h_fn(x, params.p)))(X)
                if not cfg.h_terminal:
                    # acados convention: con_h_expr stages 0..N-1 only (no
                    # con_h_expr_e in the reference). Zeroing the terminal Jacobian
                    # row removes every gradient/Hessian contribution of the
                    # stage-N barrier term (h0[-1] then only shifts a constant).
                    Jh = Jh.at[-1].set(0.0)
                    h0 = h0.at[-1].set(1.0)
            else:
                h0, Jh = None, None

            qp = BoxedQPData(
                A=A,
                B=B,
                c=c,
                Q=Qs,
                qx_base=qx_base,
                R=Rs,
                ru_base=ru_base,
                lbx=X - params.lbx,
                ubx=params.ubx - X,
                lbu=U - params.lbu,
                ubu=params.ubu - U,
                Jh=Jh,
                h0=h0,
                S=S_cross,
            )
            if qp_backend(cfg) == "pallas":
                from ..ops.pallas.riccati_qp import make_vmappable_pallas_qp

                # custom_vmap wrapper: a single tick is a fleet of one; vmapped
                # fleets (batched_solve) hand the whole fleet to one launch.
                qp_solve = make_vmappable_pallas_qp(
                    cfg.qp_iters,
                    cfg.ip_mu0,
                    cfg.ip_kappa,
                    cfg.slack_weight_l2 if cfg.soft_h else None,
                    cfg.slack_weight_l1 if cfg.soft_h else 0.0,
                    qp_interpret,
                    delta=cfg.ip_delta,
                )
                dX, dU, kkt = qp_solve(qp, x0 - X[0])
                dX = dX.astype(dtype)
                dU = dU.astype(dtype)
            else:
                dX, dU, kkt = barrier_qp_solve(
                    qp,
                    dx0=x0 - X[0],
                    num_iters=cfg.qp_iters,
                    mu0=cfg.ip_mu0,
                    kappa=cfg.ip_kappa,
                    delta=cfg.ip_delta,
                    # soft h-constraints: the barrier's quadratic extension plays
                    # the Zl L2 slack role and h_slope the zl L1 role
                    # (test_diff_mpc_dyna_slack.py:158-182)
                    h_stiffness=cfg.slack_weight_l2 if cfg.soft_h else None,
                    h_slope=cfg.slack_weight_l1 if cfg.soft_h else 0.0,
                    parallel=cfg.parallel_riccati,
                    return_kkt=True,
                )

            if cfg.line_search == "full":
                # acados SQP_RTI semantics: always the full Newton step, no
                # globalization (mpc_differential_drive_obstacle_static.py:240).
                # This is the mode the f64 oracle parity gate runs
                # (tests/test_oracle_nmpc.py); the merit search below is the
                # robust default for cold starts / far-from-track warm starts.
                return (X + dX, U + dU), kkt

            # Globalization: pick the step size minimizing an ℓ1 merit function
            # (LS cost + defect + bound-violation penalties) over a fixed candidate
            # set — a jit-friendly stand-in for the SQP line search that full-step
            # RTI omits (full step α=1 is always a candidate, so warm-started RTI
            # behavior is preserved when it already decreases the merit).
            def merit(Xc, Uc):
                if y_fn is not None:
                    Yc = jax.vmap(y_fn)(Xc[:-1], Uc)
                    ex = Yc - params.yref[:, : Yc.shape[-1]]
                    eT = y_e_fn(Xc[-1]) - params.yref_e
                    cost = 0.5 * jnp.einsum("ia,ab,ib->", ex, params.Q, ex) + (
                        0.5 * eT @ params.Qe @ eT
                    )
                else:
                    if y_x_fn is None:
                        ex = Xc[:-1] - params.yref[:, :nx]
                        eT = Xc[-1] - params.yref_e
                    else:
                        Yc = jax.vmap(y_x_fn)(Xc)
                        ex = Yc[:-1] - params.yref[:, : Yc.shape[-1]]
                        eT = Yc[-1] - params.yref_e
                    eu = Uc - params.yref[:, -nu:]
                    cost = (
                        0.5 * jnp.einsum("ix,xy,iy->", ex, params.Q, ex)
                        + 0.5 * jnp.einsum("iu,uv,iv->", eu, params.R, eu)
                        + 0.5 * eT @ params.Qe @ eT
                    )
                Fc = jax.vmap(dyn_step)(Xc[:-1], Uc)
                # The initial-condition residual is a feasibility term like the
                # shooting defects: a damped step (α<1) blends Xc[0] away from the
                # measured x0 (the QP always returns dX[0] = x0 − X[0]), and
                # without this term nothing pulls the choice back toward
                # re-anchoring the plan at the plant state (round-2 review).
                defect = jnp.sum(jnp.abs(Fc - Xc[1:])) + jnp.sum(jnp.abs(Xc[0] - x0))
                viol = (
                    jnp.sum(jnp.maximum(params.lbx - Xc, 0.0))
                    + jnp.sum(jnp.maximum(Xc - params.ubx, 0.0))
                    + jnp.sum(jnp.maximum(params.lbu - Uc, 0.0))
                    + jnp.sum(jnp.maximum(Uc - params.ubu, 0.0))
                )
                pen = jnp.asarray(1.0e3, dtype=dtype)
                m = cost + pen * (defect + viol)
                if h_fn is not None and params.p is not None:
                    # honor cfg.h_terminal: when the terminal node's h rows are
                    # excluded from the QP, the merit must not penalize terminal
                    # violations either, or the line search silently steers the
                    # iterates toward a DIFFERENT OCP than the flags define
                    # (round-4 review finding)
                    Xh = Xc if cfg.h_terminal else Xc[:-1]
                    hvals = jax.vmap(lambda x: h_fn(x, params.p))(Xh)
                    m = m + pen * jnp.sum(jnp.maximum(-hvals, 0.0))
                return m

            alphas = jnp.asarray([1.0, 0.7, 0.5, 0.35, 0.25, 0.1], dtype=dtype)
            merits = jax.vmap(lambda a: merit(X + a * dX, U + a * dU))(alphas)
            best = alphas[jnp.argmin(merits)]
            return (X + best * dX, U + best * dU), kkt

        (X, U), kkts = jax.lax.scan(
            one_sqp_iter, (state.X, state.U), None, length=cfg.sqp_iters
        )
        kkt_residual = kkts[-1]

        # Failure detection: reject non-finite solutions, keeping the warm start
        # (the reference ignores bad acados statuses and reuses the last solution,
        # mpc_differential_drive_obstacle_static.py:322-323 — here it is explicit).
        finite = jnp.all(jnp.isfinite(X)) & jnp.all(jnp.isfinite(U))
        X = jnp.where(finite, X, state.X)
        U = jnp.where(finite, U, state.U)
        status = 2 * jnp.logical_not(finite).astype(jnp.int32)

        # diagnostics
        F = jax.vmap(dyn_step)(X[:-1], U)
        defect = jnp.max(jnp.abs(F - X[1:]))
        if h_fn is not None and params.p is not None:
            h_margin = jnp.min(jax.vmap(lambda x: h_fn(x, params.p))(X))
        else:
            h_margin = jnp.asarray(jnp.inf, dtype=dtype)

        new_state = NMPCState(X=X, U=U)
        aux = NMPCAux(
            X=X,
            U=U,
            h_margin=h_margin,
            defect=defect,
            status=status,
            kkt_residual=kkt_residual,
        )
        return U[0], new_state, aux


def qp_backend(cfg: SQPConfig) -> str:
    """The QP backend a tick uses: ``cfg.qp_backend`` when set, else the
    platform's choice — the QP kernel ("pallas") on a GPU, the XLA Riccati
    ("xla") elsewhere."""
    if cfg.qp_backend is None:
        return "pallas" if platform() == "gpu" else "xla"
    if cfg.qp_backend not in ("xla", "pallas"):
        raise ValueError(f"qp_backend must be 'xla' or 'pallas': {cfg.qp_backend!r}")
    return cfg.qp_backend


class NMPCSolver:
    """Binds config + dynamics + constraints; jits the per-tick solve.

    Replaces the ``MPCController`` classes (mpc_differential_drive_obstacle_static.py:70-145,
    husky_nmpc_controller.py:72-359, mpc_racecar_class.py:68+): construction is
    trace-time, the per-tick path is one compiled XLA program with zero
    Python↔C boundaries (vs three in the l4casadi path, SURVEY §3.3).

    ``cfg.qp_backend=None`` resolves here to the platform's choice (see
    :func:`qp_backend`). ``interpret=True`` runs the QP kernel in the Pallas
    interpreter (CPU tests of ``qp_backend="pallas"``).
    """

    def __init__(
        self,
        cfg: SQPConfig,
        dynamics: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
        h_fn: Optional[HFn] = None,
        discrete: bool = False,
        y_x_fn: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
        y_fn: Optional[Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]] = None,
        y_e_fn: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
        interpret: bool = False,
    ) -> None:
        cfg = dataclasses.replace(cfg, qp_backend=qp_backend(cfg))
        self.cfg = cfg
        if discrete:
            step = dynamics
        elif cfg.integrator == "irk":
            from ..models.integrators import irk_step

            step = lambda x, u: irk_step(
                dynamics,
                x,
                u,
                cfg.dt,
                num_steps=cfg.num_rk4_steps,
                newton_iters=cfg.irk_newton_iters,
            )
        else:
            step = lambda x, u: erk_step(dynamics, x, u, cfg.dt, num_steps=cfg.num_rk4_steps)
        self.dyn_step = step
        self._h_fn = h_fn
        self._core = functools.partial(
            sqp_solve, cfg, step, h_fn, y_x_fn=y_x_fn, y_fn=y_fn, y_e_fn=y_e_fn,
            qp_interpret=interpret,
        )
        self._solve = jax.jit(self._core)
        # All-XLA twin of the core for the differentiable escape hatch
        # (solve_fn/batched_solve with differentiable=True): same semantics
        # as the pallas backend (parity-tested in tests/test_riccati_qp.py),
        # but the gradient is the exact derivative of its own forward
        # compute. Fleet scaling does NOT need this twin: batched_solve
        # keeps the QP kernel via its custom_vmap rule, and
        # make_sharded_nmpc_fleet (shard_map, per-device program) keeps it on
        # every shard.
        if cfg.qp_backend == "pallas":
            fleet_cfg = dataclasses.replace(cfg, qp_backend="xla")
            self._fleet_core = functools.partial(
                sqp_solve, fleet_cfg, step, h_fn,
                y_x_fn=y_x_fn, y_fn=y_fn, y_e_fn=y_e_fn,
            )
        else:
            self._fleet_core = self._core

    def init(self, x0: jnp.ndarray) -> NMPCState:
        return NMPCState.init(self.cfg, x0)

    def solve(
        self, params: OCPParams, state: NMPCState, x0: jnp.ndarray
    ) -> Tuple[jnp.ndarray, NMPCState, NMPCAux]:
        return self._solve(params, state, x0)

    def solve_fn(self, differentiable: bool = False):
        """The tick as a pure function ``(params, state, x0) → (u0, state, aux)``
        — for composing under jax transforms (``lax.scan`` closed loops,
        ``jax.grad`` through the controller, custom ``vmap`` axes).

        Both backends differentiate: the pallas QP carries a ``custom_vjp``
        whose default backward is the implicit-function-theorem rule — one
        factorized adjoint Riccati solve at the solution (solvers/qp.py::
        ift_qp_vjp, ~19× faster than reverse-mode through the unrolled
        forward; gradient parity pinned in tests/test_diff_nmpc.py).
        ``differentiable=True`` selects the all-XLA solve, whose gradient is
        the exact derivative of its own forward compute — the right choice
        when validating against finite differences (examples/nmpc_autotune.py,
        tests/test_diff_nmpc.py). Not jitted — jit the composition you build
        from it.
        """
        return self._fleet_core if differentiable else self._core

    def batched_solve(self, differentiable: bool = False):
        """vmapped fleet solve: (batched params, states, x0s) → batched results.

        A whole fleet of independent OCPs (multi-robot, randomized data
        collection) factors into one batched Riccati program — the
        'batched QP' scaling axis of SURVEY §2.10(c). With
        ``qp_backend="pallas"`` the whole fleet is one QP-kernel launch, one
        member per thread (the custom_vmap rule in ops/pallas/riccati_qp.py);
        with the XLA backend the B-stacked tiny matmuls batch into
        (B, nx, nx) ops. For multi-device fleets shard the batch dimension
        over a mesh axis with ``make_sharded_nmpc_fleet`` (shard_map — each
        device runs the kernel on its own fleet slice).

        The pallas backend is differentiable: its ``custom_vjp`` applies the
        IFT adjoint at the solution (one factorized Riccati solve — see
        solve_fn), so ``jax.grad`` through a pallas-backend fleet works
        directly. ``differentiable=True`` instead builds the solve
        itself on the XLA backend — gradients are then the exact derivative
        of the forward compute (what finite differences of *this* function
        measure), at the cost of the slower forward.
        """
        core = self._fleet_core if differentiable else self._core
        return jax.jit(jax.vmap(core))


__all__ = [
    "OCPParams",
    "NMPCState",
    "NMPCAux",
    "circle_obstacle_h",
    "sqp_solve",
    "qp_backend",
    "NMPCSolver",
]
