"""PPO actor-critic RL on JAX plants — the JAX re-design of the reference's
policy-gradient experiments (train/pybullet_mlp.py:25-74, test/test_rl_bullet.py:28-52).

The reference's Gaussian actor-critic (mean/log-std/value heads over a shared
trunk, clipped-surrogate update with discounted-return advantages) is kept;
the training harness is rebuilt device-first: N environments roll as one
``vmap + lax.scan`` on-device, returns/GAE are scans, and the update is a
single jitted minibatch epoch — no per-step Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax


class ActorCritic(nn.Module):
    """Gaussian policy + value over a tanh-MLP trunk.

    Head layout mirrors train/pybullet_mlp.py:25-41 (fc_mean, fc_log_std,
    value_head over shared features); the conv trunk for image observations is
    models.learned.ResNet1D — compose externally for pixel inputs.
    """

    act_dim: int
    hidden: int = 128
    depth: int = 2

    @nn.compact
    def __call__(self, obs: jnp.ndarray):
        # Separate actor/critic trunks: the reference shares one trunk (:28-32),
        # but with unnormalized returns the value gradients distort the policy
        # features — splitting is the standard continuous-control fix.
        a = obs
        for _ in range(self.depth):
            a = jnp.tanh(nn.Dense(self.hidden)(a))
        mean = nn.Dense(self.act_dim, kernel_init=nn.initializers.orthogonal(0.01))(a)
        log_std = self.param(
            "log_std", nn.initializers.constant(-0.5), (self.act_dim,)
        )
        std = jnp.maximum(jnp.exp(log_std), 1e-3)  # clamp as reference (:40)

        v = obs
        for _ in range(self.depth):
            v = jnp.tanh(nn.Dense(self.hidden)(v))
        value = nn.Dense(1)(v)[..., 0]
        return mean, std, value


class PixelActorCritic(nn.Module):
    """Gaussian policy + value over a shared conv trunk — pixel observations.

    The JAX counterpart of the reference's camera actor-critic
    (train/pybullet_mlp.py:25-52: torchvision-ResNet trunk shared by fc_mean /
    fc_log_std / value_head over PyBullet camera frames,
    test/test_rl_bullet.py:28-52). Frames here come from the on-device
    rasterizer (envs.render.raster_scene) so the whole rollout stays jitted;
    the trunk is a strided conv stack (a full ResNet-50 on a 48×48 synthetic
    frame would be all padding) with the reference's head layout preserved.
    """

    act_dim: int
    features: Tuple[int, ...] = (16, 32, 32)
    hidden: int = 128

    @nn.compact
    def __call__(self, obs: jnp.ndarray):
        def trunk(x):
            # tanh convs, not relu: on sparse blob frames with unnormalized
            # returns, relu features grow unboundedly and PPO diverges
            # (measured: relu reward -1.2→-4.5, tanh -1.1→-0.2 on the
            # point-goal task); tanh also matches the repo's MLP trunks.
            for f in self.features:
                x = jnp.tanh(nn.Conv(f, (3, 3), strides=(2, 2))(x))
            x = x.reshape(x.shape[:-3] + (-1,))
            return jnp.tanh(nn.Dense(self.hidden)(x))

        # Separate actor/critic conv trunks, same rationale as ActorCritic
        # above: unnormalized value gradients through a shared encoder swamp
        # the policy features (the reference shares its trunk, :28-32).
        a = trunk(obs)
        mean = nn.Dense(self.act_dim, kernel_init=nn.initializers.orthogonal(0.01))(a)
        log_std = self.param(
            "log_std", nn.initializers.constant(-0.5), (self.act_dim,)
        )
        std = jnp.maximum(jnp.exp(log_std), 1e-3)
        value = nn.Dense(1)(trunk(obs))[..., 0]
        return mean, std, value


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # eps_clip / gamma defaults from train/pybullet_mlp.py:49-50
    clip_eps: float = 0.2
    gamma: float = 0.99
    gae_lambda: float = 0.95
    learning_rate: float = 3.0e-4
    rollout_length: int = 128
    num_envs: int = 32
    num_epochs: int = 4
    num_minibatches: int = 4
    value_coef: float = 0.5
    entropy_coef: float = 1.0e-3
    max_grad_norm: float = 0.5


class Transition(NamedTuple):
    obs: jnp.ndarray
    action: jnp.ndarray
    log_prob: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    value: jnp.ndarray


def gaussian_log_prob(mean, std, action):
    z = (action - mean) / std
    return jnp.sum(-0.5 * z**2 - jnp.log(std) - 0.5 * jnp.log(2.0 * jnp.pi), axis=-1)


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """GAE via reverse scan (generalizes the reference's discounted returns
    at train/pybullet_mlp.py:52-61)."""

    def body(carry, inp):
        gae, next_value = carry
        reward, value, done = inp
        nonterminal = 1.0 - done
        delta = reward + gamma * next_value * nonterminal - value
        gae = delta + gamma * lam * nonterminal * gae
        return (gae, value), gae

    (_, _), advantages = jax.lax.scan(
        body,
        (jnp.zeros_like(last_value), last_value),
        (rewards, values, dones),
        reverse=True,
    )
    return advantages, advantages + values


def make_ppo_trainer(
    cfg: PPOConfig,
    model: ActorCritic,
    env_step: Callable[[jnp.ndarray, jnp.ndarray, jax.Array], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]],
    env_reset: Callable[[jax.Array], jnp.ndarray],
    obs_fn: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
):
    """Build (init_fn, train_iteration) for a vectorized JAX environment.

    ``env_step(state, action, key) -> (next_state, reward, done)`` and
    ``env_reset(key) -> state`` operate on single environments; vmap handles
    the fleet. ``obs_fn`` maps raw env states to policy observations (batched);
    identity by default — pass e.g. envs.sensors.goal_relative_obs features.
    """
    if obs_fn is None:
        obs_fn = lambda s: s
    tx = optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adam(cfg.learning_rate),
    )

    def init_fn(key):
        k1, k2 = jax.random.split(key)
        obs0 = obs_fn(env_reset(k1)[None])
        params = model.init(k2, obs0)
        return params, tx.init(params)

    def rollout(params, env_states, key):
        def step(carry, _):
            env_states, key = carry
            key, k_act, k_env, k_reset = jax.random.split(key, 4)
            mean, std, value = model.apply(params, obs_fn(env_states))
            action = mean + std * jax.random.normal(k_act, mean.shape)
            logp = gaussian_log_prob(mean, std, action)
            keys = jax.random.split(k_env, env_states.shape[0])
            nxt, reward, done = jax.vmap(env_step)(env_states, action, keys)
            # auto-reset finished envs
            reset_keys = jax.random.split(k_reset, env_states.shape[0])
            fresh = jax.vmap(env_reset)(reset_keys)
            nxt = jnp.where(done[:, None], fresh, nxt)
            tr = Transition(
                obs_fn(env_states), action, logp, reward, done.astype(jnp.float32), value
            )
            return (nxt, key), tr

        (env_states, key), traj = jax.lax.scan(
            step, (env_states, key), None, length=cfg.rollout_length
        )
        return env_states, traj, key

    def update(params, opt_state, traj: Transition, last_value, key):
        adv, returns = compute_gae(
            traj.reward, traj.value, traj.done, last_value, cfg.gamma, cfg.gae_lambda
        )
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)

        batch = jax.tree.map(lambda a: a.reshape((-1,) + a.shape[2:]), traj)
        adv_f = adv.reshape(-1)
        ret_f = returns.reshape(-1)
        n = adv_f.shape[0]

        def loss_fn(p, mb_idx):
            obs = batch.obs[mb_idx]
            mean, std, value = model.apply(p, obs)
            logp = gaussian_log_prob(mean, std, batch.action[mb_idx])
            ratio = jnp.exp(logp - batch.log_prob[mb_idx])
            a = adv_f[mb_idx]
            # clipped surrogate (train/pybullet_mlp.py:65-70)
            surr1 = ratio * a
            surr2 = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * a
            policy_loss = -jnp.mean(jnp.minimum(surr1, surr2))
            value_loss = jnp.mean((value - ret_f[mb_idx]) ** 2)
            entropy = jnp.mean(jnp.sum(jnp.log(std) + 0.5 * (1 + jnp.log(2 * jnp.pi)), axis=-1))
            total = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy
            return total, (policy_loss, value_loss)

        mb_size = n // cfg.num_minibatches

        def epoch(carry, k):
            params, opt_state = carry
            perm = jax.random.permutation(k, n)

            def mb(carry, i):
                params, opt_state = carry
                idx = jax.lax.dynamic_slice_in_dim(perm, i * mb_size, mb_size)
                (tot, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, idx)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), tot

            (params, opt_state), losses = jax.lax.scan(
                mb, (params, opt_state), jnp.arange(cfg.num_minibatches)
            )
            return (params, opt_state), losses.mean()

        (params, opt_state), losses = jax.lax.scan(
            epoch, (params, opt_state), jax.random.split(key, cfg.num_epochs)
        )
        return params, opt_state, losses.mean()

    @jax.jit
    def train_iteration(params, opt_state, env_states, key):
        env_states, traj, key = rollout(params, env_states, key)
        _, _, last_value = model.apply(params, obs_fn(env_states))
        key, k_up = jax.random.split(key)
        params, opt_state, loss = update(params, opt_state, traj, last_value, k_up)
        metrics = {
            "loss": loss,
            "mean_reward": traj.reward.mean(),
            "mean_value": traj.value.mean(),
        }
        return params, opt_state, env_states, key, metrics

    return init_fn, train_iteration


__all__ = [
    "ActorCritic",
    "PixelActorCritic",
    "PPOConfig",
    "Transition",
    "compute_gae",
    "make_ppo_trainer",
]
