"""Pixel-input PPO on a goal-seeking unicycle — the camera-RL path.

The reference trains a ResNet-50 actor-critic on PyBullet camera frames
(train/pybullet_mlp.py:25-52, test/test_rl_bullet.py:28-52). Here the frames
come from the on-device rasterizer (envs/render.raster_scene): a fleet of
unicycles learns to reach the origin from top-down images with an obstacle in
view — rendering, rollouts, GAE, and the clipped-surrogate update are one
jitted program with zero per-frame host round-trips.

    python examples/ppo_pixel_goal.py --iters 120
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.envs.render import raster_scene
from dnn_mppi_mpc.models import euler_step, unicycle
from dnn_mppi_mpc.train.rl import PixelActorCritic, PPOConfig, make_ppo_trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--size", type=int, default=32, help="frame resolution")
    args = ap.parse_args()

    dt = 0.15
    goal = jnp.zeros(2)
    obstacle = jnp.array([[1.2, 1.2, 0.5]])

    def env_reset(key):
        return jax.random.uniform(key, (3,), minval=-2.0, maxval=2.0)

    def env_step(state, action, key):
        action = jnp.clip(action, -1.5, 1.5)
        nxt = euler_step(unicycle, state, action, dt)
        nxt = nxt.at[:2].set(jnp.clip(nxt[:2], -3.0, 3.0))
        d = jnp.linalg.norm(nxt[:2])
        hit = jnp.linalg.norm(nxt[:2] - obstacle[0, :2]) < obstacle[0, 2]
        reward = -d - 0.05 * jnp.sum(action**2) - 5.0 * hit
        done = d < 0.1
        return nxt, reward, done

    def obs_fn(states):  # (N, 3) poses -> (N, size, size, 3) frames
        return jax.vmap(
            lambda p: raster_scene(p, goal, obstacle, size=args.size, extent=3.0)
        )(states)

    cfg = PPOConfig(num_envs=args.envs, rollout_length=96, learning_rate=1e-3)
    model = PixelActorCritic(act_dim=2, features=(16, 32, 32), hidden=128)
    init_fn, train_iter = make_ppo_trainer(cfg, model, env_step, env_reset, obs_fn=obs_fn)

    key = jax.random.PRNGKey(0)
    params, opt_state = init_fn(key)
    env_states = jax.vmap(env_reset)(jax.random.split(key, cfg.num_envs))

    for i in range(args.iters):
        params, opt_state, env_states, key, metrics = train_iter(
            params, opt_state, env_states, key
        )
        if i % 10 == 0 or i == args.iters - 1:
            print(
                f"iter {i:4d}  reward {float(metrics['mean_reward']):8.3f}  "
                f"loss {float(metrics['loss']):8.3f}"
            )

    # greedy eval episode from a fixed start
    x = jnp.array([-2.0, 1.5, 0.0])
    for _ in range(120):
        mean, _, _ = model.apply(params, obs_fn(x[None]))
        x, r, d = env_step(x, mean[0], jax.random.PRNGKey(1))
        if bool(d):
            break
    print(f"eval final distance to goal: {float(jnp.linalg.norm(x[:2])):.3f} m")


if __name__ == "__main__":
    main()
