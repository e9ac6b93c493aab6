"""Differentiable NMPC: auto-tune cost weights by gradient through the loop.

The whole controller — SQP linearization, barrier-Riccati QP, merit line
search, plant rollout — is one differentiable JAX graph, so ``jax.grad`` of
a closed-loop objective w.r.t. the OCP cost weights is exact (no finite
differences, no derivative-free search). This is a capability the reference
architecture cannot express at all: its controller crosses Python→acados-C
→libtorch boundaries per tick (SURVEY §3.3), which no autodiff can see
through. Here: θ = log-diagonal Q/R weights → 20-tick closed-loop tracking
+ effort + terminal loss → Adam. Gradients are validated against central
finite differences in tests/test_diff_nmpc.py.

Uses the XLA Riccati backend so the gradient is the exact derivative of the
forward compute (the pallas QP backend also differentiates — its custom_vjp
recomputes the backward through the XLA graph; tests/test_diff_nmpc.py pins
the parity).

    python examples/nmpc_autotune.py --iters 40
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, NMPCState, OCPParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.15)
    args = ap.parse_args()

    cfg = SQPConfig(
        N=args.horizon, dim_x=3, dim_u=2, dt=0.1,
        sqp_iters=1, qp_iters=6, qp_backend="xla",
    )
    solver = NMPCSolver(cfg, unicycle)
    tick = solver.solve_fn(differentiable=True)
    goal = jnp.array([1.5, 1.0, 0.5], jnp.float32)
    x0s = jnp.array(
        [[0.2, -0.1, 0.0], [-0.3, 0.3, 0.4], [0.0, 0.0, -0.5]], jnp.float32
    )

    def closed_loop_loss(theta, x0):
        """Tracking + effort + terminal loss of args.ticks closed-loop ticks
        under weights θ = log diag(Q, R)."""
        qdiag, rdiag = jnp.exp(theta[:3]), jnp.exp(theta[3:])
        op = OCPParams(
            Q=jnp.diag(qdiag), R=jnp.diag(rdiag), Qe=jnp.diag(qdiag),
            yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(
                cfg.N, axis=0
            ),
            yref_e=goal,
            lbx=jnp.full(3, -10.0), ubx=jnp.full(3, 10.0),
            lbu=jnp.full(2, -5.0), ubu=jnp.full(2, 5.0),
        )

        def body(carry, _):
            st, x = carry
            u0, st, _ = tick(op, st, x)
            x = solver.dyn_step(x, u0)
            return (st, x), (jnp.sum((x[:2] - goal[:2]) ** 2), jnp.sum(u0**2))

        (_, xf), (track, effort) = jax.lax.scan(
            body, (NMPCState.init(cfg, x0), x0), None, length=args.ticks
        )
        return jnp.sum(track) + 0.02 * jnp.sum(effort) + 20.0 * jnp.sum(
            (xf[:2] - goal[:2]) ** 2
        )

    def objective(theta):
        return jnp.mean(jax.vmap(lambda x: closed_loop_loss(theta, x))(x0s))

    # deliberately poor initial weights: heading over-weighted, sluggish R
    theta = jnp.log(jnp.array([0.5, 0.5, 5.0, 3.0, 3.0], jnp.float32))
    opt = optax.adam(args.lr)
    opt_state = opt.init(theta)

    @jax.jit
    def step(th, os_):
        v, g = jax.value_and_grad(objective)(th)
        updates, os2 = opt.update(g, os_, th)
        return v, optax.apply_updates(th, updates), os2

    v0 = None
    for it in range(args.iters):
        v, theta, opt_state = step(theta, opt_state)
        v0 = v if v0 is None else v0
        if it % max(1, args.iters // 10) == 0 or it == args.iters - 1:
            print(f"iter {it:3d}  closed-loop loss {float(v):.4f}")
    qd, rd = jnp.exp(theta[:3]), jnp.exp(theta[3:])
    print(
        f"loss {float(v0):.3f} -> {float(v):.3f} "
        f"({float(v0 / v):.1f}x better); tuned diag(Q)={qd}, diag(R)={rd}"
    )


if __name__ == "__main__":
    main()
