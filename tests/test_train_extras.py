"""Excitation signals, Latin hypercube, and PPO trainer tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.train.excitation import (
    latin_hypercube,
    multisine_sequence,
    ramp_sequence,
    random_sequence,
    sine_sequence,
    step_sequence,
)
from dnn_mppi_mpc.train.rl import ActorCritic, PPOConfig, compute_gae, make_ppo_trainer


def test_step_ramp_sine_shapes_and_bounds():
    amps = jnp.array([1.0, 0.5])
    s = step_sequence(40, amps, period=10)
    assert s.shape == (40, 2)
    np.testing.assert_allclose(np.abs(np.asarray(s)), np.tile([1.0, 0.5], (40, 1)))
    # alternation every `period`
    np.testing.assert_allclose(np.asarray(s[0]), -np.asarray(s[10]))

    r = ramp_sequence(50, jnp.array([0.1, 0.2]), jnp.array([2.0, 3.0]))
    assert float(jnp.max(r[:, 0])) <= 2.0 and float(jnp.max(r[:, 1])) <= 3.0

    w = sine_sequence(100, amps, jnp.array([1.0, 2.0]), dt=0.01)
    assert float(jnp.max(jnp.abs(w))) <= 1.0 + 1e-6


def test_random_sequence_hold():
    u = random_sequence(jax.random.PRNGKey(0), 20, jnp.array([-1.0]), jnp.array([1.0]), hold=5)
    u = np.asarray(u)
    assert u.shape == (20, 1)
    for b in range(4):
        assert np.allclose(u[5 * b : 5 * (b + 1)], u[5 * b])


def test_multisine_is_smooth_and_bounded():
    u = multisine_sequence(jax.random.PRNGKey(1), 200, 2)
    assert u.shape == (200, 2)
    assert float(jnp.max(jnp.abs(u))) < 2.0


def test_latin_hypercube_stratification():
    bounds = jnp.array([[0.0, 1.0], [-2.0, 2.0], [5.0, 10.0]])
    n = 50
    x = np.asarray(latin_hypercube(jax.random.PRNGKey(2), n, bounds))
    assert x.shape == (n, 3)
    for d in range(3):
        lo, hi = bounds[d]
        assert np.all(x[:, d] >= float(lo)) and np.all(x[:, d] <= float(hi))
        # exactly one sample per stratum
        strata = ((x[:, d] - float(lo)) / (float(hi) - float(lo)) * n).astype(int)
        assert len(np.unique(np.clip(strata, 0, n - 1))) == n


def test_gae_matches_discounted_returns_when_lambda_1():
    T = 5
    rewards = jnp.ones((T, 1))
    values = jnp.zeros((T, 1))
    dones = jnp.zeros((T, 1))
    adv, ret = compute_gae(rewards, values, dones, jnp.zeros((1,)), gamma=0.9, lam=1.0)
    # with V=0, λ=1: returns are plain discounted sums (pybullet_mlp.py:52-61)
    want = np.array([sum(0.9**k for k in range(T - t)) for t in range(T)])
    np.testing.assert_allclose(np.asarray(ret[:, 0]), want, rtol=1e-5)


@pytest.mark.slow
def test_ppo_learns_point_goal():
    """PPO on a 2-D point-mass 'reach the origin' task must improve reward."""
    dt = 0.1

    def env_reset(key):
        return jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)

    def env_step(state, action, key):
        action = jnp.clip(action, -1.0, 1.0)
        nxt = jnp.clip(state + dt * action, -1.5, 1.5)  # bounded arena
        reward = -jnp.sum(nxt**2) - 0.01 * jnp.sum(action**2)
        done = jnp.linalg.norm(nxt) < 0.05
        return nxt, reward, done

    cfg = PPOConfig(num_envs=16, rollout_length=64, learning_rate=1e-3)
    model = ActorCritic(act_dim=2, hidden=32, depth=2)
    init_fn, train_iter = make_ppo_trainer(cfg, model, env_step, env_reset)

    key = jax.random.PRNGKey(0)
    params, opt_state = init_fn(key)
    env_states = jax.vmap(env_reset)(jax.random.split(key, cfg.num_envs))

    rewards = []
    for i in range(30):
        params, opt_state, env_states, key, metrics = train_iter(
            params, opt_state, env_states, key
        )
        rewards.append(float(metrics["mean_reward"]))
    early = np.mean(rewards[:5])
    late = np.mean(rewards[-5:])
    assert late > early, (early, late)


def test_raster_scene_observability():
    """Rasterizer: channels light up at the right world positions and the
    heading marker makes orientation observable from one frame."""
    from dnn_mppi_mpc.envs.render import raster_scene

    size, extent = 32, 4.0
    img = raster_scene(
        jnp.array([1.0, -2.0, 0.0]),
        jnp.array([-3.0, 3.0]),
        jnp.array([[0.0, 0.0, 0.8]]),
        size=size,
        extent=extent,
    )
    assert img.shape == (size, size, 3)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0

    def to_px(x, y):
        # meshgrid(indexing='xy'): column ~ x, row ~ y
        col = int(round((x + extent) / (2 * extent) * (size - 1)))
        row = int(round((y + extent) / (2 * extent) * (size - 1)))
        return row, col

    r, c = to_px(1.0, -2.0)
    assert float(img[r, c, 0]) > 0.8  # robot body
    r, c = to_px(-3.0, 3.0)
    assert float(img[r, c, 1]) > 0.8  # goal
    r, c = to_px(0.0, 0.0)
    assert float(img[r, c, 2]) > 0.9  # obstacle interior

    # heading observability: rotating the robot must change the image
    img2 = raster_scene(
        jnp.array([1.0, -2.0, 2.0]),
        jnp.array([-3.0, 3.0]),
        None,
        size=size,
        extent=extent,
    )
    assert float(jnp.max(jnp.abs(img2[..., 0] - img[..., 0]))) > 0.3


@pytest.mark.slow
def test_pixel_ppo_learns_point_goal():
    """Pixel-input PPO parity (train/pybullet_mlp.py:25-52): the conv
    actor-critic on rasterized frames must improve reward on the same
    point-goal task the state-input test uses — the reference's
    camera-image RL experiment re-created without a physics renderer."""
    from dnn_mppi_mpc.envs.render import raster_scene
    from dnn_mppi_mpc.train.rl import PixelActorCritic

    dt = 0.2
    goal = jnp.zeros(2)

    def env_reset(key):
        return jax.random.uniform(key, (2,), minval=-1.2, maxval=1.2)

    def env_step(state, action, key):
        action = jnp.clip(action, -1.0, 1.0)
        nxt = jnp.clip(state + dt * action, -1.5, 1.5)
        reward = -jnp.sum(nxt**2) - 0.01 * jnp.sum(action**2)
        done = jnp.linalg.norm(nxt) < 0.05
        return nxt, reward, done

    def obs_fn(states):  # (N, 2) -> (N, 16, 16, 3)
        pose = jnp.concatenate([states, jnp.zeros_like(states[..., :1])], axis=-1)
        return jax.vmap(
            lambda p: raster_scene(p, goal, None, size=16, extent=2.0)
        )(pose)

    cfg = PPOConfig(num_envs=16, rollout_length=64, learning_rate=1e-3)
    model = PixelActorCritic(act_dim=2, features=(8, 16), hidden=32)
    init_fn, train_iter = make_ppo_trainer(cfg, model, env_step, env_reset, obs_fn=obs_fn)

    key = jax.random.PRNGKey(1)
    params, opt_state = init_fn(key)
    env_states = jax.vmap(env_reset)(jax.random.split(key, cfg.num_envs))

    rewards = []
    for _ in range(60):
        params, opt_state, env_states, key, metrics = train_iter(
            params, opt_state, env_states, key
        )
        rewards.append(float(metrics["mean_reward"]))
    early = np.mean(rewards[:5])
    late = np.mean(rewards[-5:])
    assert late > early + 0.3, (early, late)
