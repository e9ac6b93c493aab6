"""Control-noise sampling with explicit PRNG keys.

Replaces the reference's global-RNG multivariate normal draw
(controllers/mppi_differential_drive.py:273-283,
``np.random.multivariate_normal(mu, sigma, (K, T))``) with key-threaded
sampling: standard normals are colored by the Cholesky factor of Σ. For
oracle-parity testing the solvers also accept a pre-drawn noise tensor, so
identical ε can be injected into both the numpy oracle and the JAX engine
(SURVEY §7 "Noise/RNG parity").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_noise(
    key: jax.Array,
    sigma: jnp.ndarray,
    num_samples: int,
    horizon: int,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Draw ε ~ N(0, Σ) with shape (K, T, dim_u).

    Equivalent in distribution to ``np.random.multivariate_normal`` at
    controllers/mppi_differential_drive.py:282 but deterministic under a key.
    """
    dim_u = sigma.shape[-1]
    chol = small_cholesky(sigma.astype(_hi_dtype())).astype(dtype)
    z = jax.random.normal(key, (num_samples, horizon, dim_u), dtype=dtype)
    # ε = z Lᵀ as a broadcast multiply-sum, not a matmul: with a contraction
    # of dim_u (2-4) a GPU matmul is a library call at a fraction of its
    # rate, while the elementwise form fuses into the sampling in exact f32
    return jnp.sum(z[..., None, :] * chol, axis=-1)


def small_cholesky(a: jnp.ndarray) -> jnp.ndarray:
    """Unrolled Cholesky–Crout for tiny static dims (control spaces, n ≤ ~8).

    jnp.linalg.cholesky lowers to a library call whose launch costs far more
    than the arithmetic of a 2×2. The control-noise Σ is (dim_u × dim_u) with
    dim_u ∈ {2, 4}, so a fully unrolled scalar recurrence compiles to a
    handful of fused ops.
    """
    n = a.shape[-1]
    rows = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                # Scale-aware pivot clamp: f32 cancellation can push a
                # barely-PD pivot negative (sqrt → NaN where pivoted LU would
                # survive); barrier-regularized Hessians with O(1e6) stiffness
                # sit exactly on this edge. Flooring at eps_rel·a[i,i] keeps
                # the factor conditioned instead of exploding the solve.
                # |a[i,i]|: the diagonal itself can round negative under f32
                # cancellation (observed on an accelerator, not the CPU —
                # different FMA order), which would make the floor negative and re-admit
                # sqrt(negative) → NaN.
                floor = jnp.asarray(1e-6, s.dtype) * jnp.abs(a[i, i]) + jnp.asarray(
                    1e-30, s.dtype
                )
                rows[i][j] = jnp.sqrt(jnp.maximum(s, floor))
            else:
                rows[i][j] = s / rows[j][j]
        for j in range(i + 1, n):
            rows[i][j] = jnp.zeros_like(a[0, 0])
    return jnp.stack([jnp.stack(r) for r in rows])


def _hi_dtype():
    """f64 when enabled (tests), else f32 — avoids noisy truncation warnings."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def sigma_inverse(sigma: jnp.ndarray) -> jnp.ndarray:
    """Σ⁻¹ for the control-energy term — unrolled SPD inverse via Cholesky
    (jnp.linalg.inv has the same heavyweight lowering as cholesky; see
    :func:`small_cholesky`)."""
    a = sigma.astype(_hi_dtype())
    n = a.shape[-1]
    L = small_cholesky(a)
    # unrolled forward substitution: L X = I  →  X = L⁻¹
    X = [[None] * n for _ in range(n)]
    for j in range(n):
        for i in range(n):
            if i < j:
                X[i][j] = jnp.zeros_like(a[0, 0])
            else:
                s = jnp.ones_like(a[0, 0]) if i == j else jnp.zeros_like(a[0, 0])
                for k in range(j, i):
                    s = s - L[i, k] * X[k][j]
                X[i][j] = s / L[i, i]
    Linv = jnp.stack([jnp.stack(r) for r in X])
    return jnp.matmul(Linv.T, Linv, precision=jax.lax.Precision.HIGHEST).astype(
        sigma.dtype
    )


def small_lu_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a·x = b for tiny ``a`` via unrolled partial-pivot LU.

    ``b`` may be (n,) or (n, m). Same speed rationale as
    :func:`small_cholesky`: ``jnp.linalg.solve`` on a 2×2 inside a
    ``lax.scan`` body lowers to a batched-LU path whose per-step cost dwarfs
    the arithmetic — on the latency-bound Riccati backward sweep
    (solvers/qp.py) this is the difference between µs- and ms-scale NMPC
    ticks (on the GPU a library solve is several launches per call).

    Partial pivoting (not Cholesky) because the input is only *nominally*
    SPD: in f32, the Riccati cost-to-go update cancels catastrophically once
    barrier quadratic-extension stiffness (~1e6) enters the Hessians, and
    ``Luu = R + BᵀPB`` can come out indefinite (observed on an accelerator:
    a −81.6 diagonal at barrier iteration 9). LU with row pivoting returns the same
    bounded step as ``jnp.linalg.solve`` there — the barrier loop's
    fraction-to-boundary damping then self-corrects — whereas any Cholesky
    pivot-clamping scheme turns the negative pivot into a ~1e13 gain and
    destroys the recursion."""
    n = a.shape[-1]
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    rows = [jnp.concatenate([a[i], B[i]]) for i in range(n)]
    for i in range(n):
        # bubble the max-|column i| row into position i (unrolled pivoting)
        for j in range(i + 1, n):
            swap = jnp.abs(rows[j][i]) > jnp.abs(rows[i][i])
            hi = jnp.where(swap, rows[j], rows[i])
            lo = jnp.where(swap, rows[i], rows[j])
            rows[i], rows[j] = hi, lo
        piv = rows[i]
        inv_p = 1.0 / piv[i]
        for j in range(i + 1, n):
            rows[j] = rows[j] - (rows[j][i] * inv_p) * piv
    xs: list = [None] * n
    for i in reversed(range(n)):  # back substitution
        s = rows[i][n:]
        for k in range(i + 1, n):
            s = s - rows[i][k] * xs[k]
        xs[i] = s / rows[i][i]
    X = jnp.stack(xs)
    return X[:, 0] if vec else X


__all__ = ["sample_noise", "sigma_inverse", "small_cholesky", "small_lu_solve"]
