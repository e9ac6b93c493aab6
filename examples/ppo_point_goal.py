"""PPO on a goal-seeking unicycle — the RL path (train/pybullet_mlp.py redone).

A vectorized fleet of unicycle robots learns to reach the origin using
goal-relative observations (envs/sensors.goal_relative_obs); rollouts,
GAE, and the clipped-surrogate update all run on-device.

    python examples/ppo_point_goal.py --iters 80
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.envs.sensors import goal_relative_obs
from dnn_mppi_mpc.models import euler_step, unicycle
from dnn_mppi_mpc.train.rl import ActorCritic, PPOConfig, make_ppo_trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--envs", type=int, default=32)
    args = ap.parse_args()

    dt = 0.1

    def env_reset(key):
        return jax.random.uniform(key, (3,), minval=-2.0, maxval=2.0)

    def env_step(state, action, key):
        action = jnp.clip(action, -1.5, 1.5)
        nxt = euler_step(unicycle, state, action, dt)
        nxt = nxt.at[:2].set(jnp.clip(nxt[:2], -3.0, 3.0))
        d = jnp.linalg.norm(nxt[:2])
        reward = -d - 0.05 * jnp.sum(action**2)
        done = d < 0.1
        return nxt, reward, done

    cfg = PPOConfig(num_envs=args.envs, rollout_length=64, learning_rate=1e-3)
    # observation = goal-relative features of the raw state
    model = ActorCritic(act_dim=2, hidden=64, depth=2)

    goal = jnp.zeros(3)
    obs_fn = lambda s: goal_relative_obs(s, goal)

    init_fn, train_iter = make_ppo_trainer(cfg, model, env_step, env_reset, obs_fn=obs_fn)
    key = jax.random.PRNGKey(0)
    params, opt_state = init_fn(key)
    env_states = jax.vmap(env_reset)(jax.random.split(key, cfg.num_envs))

    for i in range(args.iters):
        params, opt_state, env_states, key, m = train_iter(params, opt_state, env_states, key)
        if i % 10 == 0:
            print(
                f"iter {i:3d}  mean reward {float(m['mean_reward']):+.3f}  "
                f"loss {float(m['loss']):.3f}"
            )

    # evaluate the deterministic policy
    x = jnp.array([1.5, -1.2, 0.8])
    for _ in range(80):
        mean, _, _ = model.apply(params, obs_fn(x)[None])
        x, r, d = env_step(x, mean[0], key)
    print(f"eval final distance to goal: {float(jnp.linalg.norm(x[:2])):.3f} m")


if __name__ == "__main__":
    main()
