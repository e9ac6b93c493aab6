"""Cross-entropy method (CEM) trajectory optimizer.

The reference declares this solver but never implements it
(controllers/mppi_differential_drive.py:251-252, ``_cross_entropy: pass``).
Here it is, built on the same batched rollout machinery as the MPPI engine:
sample K control sequences from a per-timestep Gaussian, roll out and score
with the same stage/terminal cost interface, select the elite fraction, refit
mean and (diagonal) covariance, iterate. Fully jitted: the inner CEM
iterations are a ``lax.scan``; K is the batch dimension exactly as in MPPI.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class

from ..config import MPPIParams
from .mppi import CostContext, StageCost, TerminalCost, unify_float_dtype
from ..ops.waypoints import nearest_waypoint


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    """Static CEM configuration (shares the problem dims with MPPIConfig)."""

    num_samples: int  # K
    horizon: int  # T
    dim_x: int
    dim_u: int
    dt: float
    num_iters: int = 5  # CEM refinement iterations per control tick
    elite_fraction: float = 0.1
    init_std: float = 0.5
    min_std: float = 0.05  # floor keeps exploration alive (prevents collapse)
    momentum: float = 0.25  # EMA smoothing of mean/std across iterations
    time_varying_dynamics: bool = False  # dynamics_step is F(x, u, t), t the
    # int32 rollout step index (test/test_mppi_diff_obs.py:28-42)
    waypoint_search_len: int = 20


@register_pytree_node_class
@dataclasses.dataclass
class CEMState:
    """Carried distribution over control sequences + waypoint window + key."""

    mean: jnp.ndarray  # (T, dim_u)
    std: jnp.ndarray  # (T, dim_u)
    waypoint_idx: jnp.ndarray
    key: jax.Array

    def tree_flatten(self):
        return (self.mean, self.std, self.waypoint_idx, self.key), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def init(cls, cfg: CEMConfig, key: Optional[jax.Array] = None) -> "CEMState":
        return cls(
            mean=jnp.zeros((cfg.horizon, cfg.dim_u), jnp.float32),
            std=jnp.full((cfg.horizon, cfg.dim_u), cfg.init_std, jnp.float32),
            waypoint_idx=jnp.zeros((), jnp.int32),
            key=key if key is not None else jax.random.PRNGKey(0),
        )


class CEMAux(NamedTuple):
    elite_cost: jnp.ndarray  # mean cost of the elite set at the last iteration
    best_cost: jnp.ndarray


def cem_step(
    cfg: CEMConfig,
    dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    stage_cost: StageCost,
    terminal_cost: TerminalCost,
    params: MPPIParams,
    state: CEMState,
    x0: jnp.ndarray,
) -> Tuple[jnp.ndarray, CEMState, CEMAux]:
    """One CEM control tick: iterate sample→rollout→elite-refit, then shift."""
    K, T = cfg.num_samples, cfg.horizon
    n_elite = max(1, int(K * cfg.elite_fraction))
    x0 = x0.astype(state.mean.dtype)
    params = unify_float_dtype(params, state.mean.dtype)

    wp_idx, _ = nearest_waypoint(
        params.ref_path, x0[:2], state.waypoint_idx, cfg.waypoint_search_len
    )
    ctx = CostContext(params=params, waypoint_start=wp_idx)

    def rollout_costs(v):
        """(K, T, nu) clamped sequences → (K,) summed costs."""
        v_time = jnp.swapaxes(v, 0, 1)

        def body(carry, inp):
            x, s = carry
            v_t, t = inp
            if cfg.time_varying_dynamics:
                x = dynamics_step(x, v_t, t)
            else:
                x = dynamics_step(x, v_t)
            return (x, s + stage_cost(x, t, ctx)), None

        x_init = jnp.broadcast_to(x0, (K,) + x0.shape)
        (x_fin, S), _ = jax.lax.scan(
            body,
            (x_init, jnp.zeros((K,), x0.dtype)),
            (v_time, jnp.arange(T, dtype=jnp.int32)),
        )
        return S + terminal_cost(x_fin, ctx)

    def one_iter(carry, key):
        mean, std = carry
        eps = jax.random.normal(key, (K, T, cfg.dim_u), mean.dtype)
        v = jnp.clip(mean[None] + std[None] * eps, params.u_min, params.u_max)
        S = rollout_costs(v)
        order = jnp.argsort(S)
        elite = jnp.take(v, order[:n_elite], axis=0)  # (n_elite, T, nu)
        new_mean = jnp.mean(elite, axis=0)
        new_std = jnp.maximum(jnp.std(elite, axis=0), cfg.min_std)
        mean = cfg.momentum * mean + (1.0 - cfg.momentum) * new_mean
        std = cfg.momentum * std + (1.0 - cfg.momentum) * new_std
        stats = (jnp.mean(S[order[:n_elite]]), S[order[0]])
        return (mean, std), stats

    key, *iter_keys = jax.random.split(state.key, cfg.num_iters + 1)
    (mean, std), (elite_costs, best_costs) = jax.lax.scan(
        one_iter, (state.mean, state.std), jnp.stack(iter_keys)
    )

    u0 = mean[0]
    # receding-horizon shift of the distribution
    mean_shift = jnp.concatenate([mean[1:], mean[-1:]], axis=0)
    std_shift = jnp.concatenate([std[1:], jnp.full_like(std[-1:], cfg.init_std)], axis=0)
    new_state = CEMState(mean=mean_shift, std=std_shift, waypoint_idx=wp_idx, key=key)
    return u0, new_state, CEMAux(elite_cost=elite_costs[-1], best_cost=best_costs[-1])


class CEMSolver:
    """Convenience wrapper mirroring MPPISolver."""

    def __init__(
        self,
        cfg: CEMConfig,
        dynamics_step: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
        stage_cost: StageCost,
        terminal_cost: TerminalCost,
    ) -> None:
        self.cfg = cfg
        self._step = jax.jit(
            functools.partial(cem_step, cfg, dynamics_step, stage_cost, terminal_cost)
        )

    def init(self, key: Optional[jax.Array] = None) -> CEMState:
        return CEMState.init(self.cfg, key)

    def step(self, params: MPPIParams, state: CEMState, x0: jnp.ndarray):
        return self._step(params, state, x0)


__all__ = ["CEMConfig", "CEMState", "CEMAux", "cem_step", "CEMSolver"]
