"""Unit tests: filters (vs scipy/numpy references), waypoints, costs, sampling."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.signal import savgol_filter as scipy_savgol

from dnn_mppi_mpc.ops.costs import (
    circle_robot_collision,
    control_energy_cost,
    einsum_quadratic_cost,
    soft_obstacle_cost,
    vehicle_polygon_collision,
)
from dnn_mppi_mpc.ops.filters import (
    moving_average_edge,
    moving_average_padded,
    savgol_filter,
)
from dnn_mppi_mpc.ops.sampling import sample_noise, sigma_inverse
from dnn_mppi_mpc.ops.waypoints import nearest_waypoint


def _ref_moving_average_edge(xx, window_size):
    # independent scalar port of mppi_differential_drive.py:257-271 semantics
    b = np.ones(window_size) / window_size
    out = np.zeros_like(xx)
    n_conv = math.ceil(window_size / 2)
    for d in range(xx.shape[1]):
        out[:, d] = np.convolve(xx[:, d], b, mode="same")
        out[0, d] *= window_size / n_conv
        for i in range(1, n_conv):
            out[i, d] *= window_size / (i + n_conv)
            out[-1, d] *= window_size / (i + n_conv - (window_size % 2))
    return out


def _ref_moving_average_padded(xx, window_size):
    # scalar port of mppi_race_car_obstacle.py:228-239 semantics
    k = window_size
    kernel = np.ones(k) / k
    out = np.zeros_like(xx)
    for d in range(xx.shape[1]):
        padded = np.concatenate([xx[: k // 2, d], xx[:, d], xx[-(k // 2) :, d]])
        out[:, d] = np.convolve(padded, kernel, mode="same")[k // 2 : -(k // 2)]
    return out


@pytest.mark.parametrize("T,w", [(10, 10), (20, 10), (50, 10), (25, 7)])
def test_moving_average_edge_matches_reference(T, w):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(T, 2))
    got = np.asarray(moving_average_edge(jnp.asarray(x, jnp.float64), w))
    np.testing.assert_allclose(got, _ref_moving_average_edge(x, w), rtol=1e-10)


@pytest.mark.parametrize("T,w", [(10, 10), (20, 10), (50, 8)])
def test_moving_average_padded_matches_reference(T, w):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(T, 2))
    got = np.asarray(moving_average_padded(jnp.asarray(x, jnp.float64), w))
    np.testing.assert_allclose(got, _ref_moving_average_padded(x, w), rtol=1e-10)


@pytest.mark.parametrize("T,w,p", [(50, 11, 3), (60, 21, 3), (50, 51, 3)])
def test_savgol_matches_scipy(T, w, p):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(T, 2))
    got = np.asarray(savgol_filter(jnp.asarray(x, jnp.float64), w, p))
    # smooth_control_input clamps window to T and forces odd (test_mppi_diff_obs.py:275-286)
    w_eff = min(w, T)
    if w_eff % 2 == 0:
        w_eff -= 1
    want = np.apply_along_axis(scipy_savgol, 0, x, w_eff, min(p, w_eff - 1))
    np.testing.assert_allclose(got, want, atol=1e-8)


@pytest.mark.parametrize(
    "kind,T,w,p",
    [
        ("ma_edge", 50, 10, 0),
        ("ma_edge", 10, 10, 0),
        ("ma_edge", 25, 7, 0),
        ("ma_padded", 50, 8, 0),
        ("ma_padded", 20, 10, 0),
        ("savgol", 50, 11, 3),
        ("savgol", 60, 21, 3),
        ("savgol", 50, 51, 3),  # window clamps to T, forced odd
        ("savgol", 30, 4, 5),  # even window, polyorder clamp
        # degenerate windows must be identity in BOTH paths — w=1 previously
        # returned a (2T, T) matrix / an empty array (round-2 review finding)
        ("ma_padded", 20, 1, 0),
        ("ma_padded", 1, 8, 0),  # T=1 clamps the window to 1
        ("ma_edge", 20, 1, 0),
        ("savgol", 20, 1, 3),
    ],
)
def test_filter_matrix_equals_op_path(kind, T, w, p):
    """apply_filter's hot path is one precomputed (T, T) matmul; pin it to the
    reference-semantics op implementations (linear filters → exact matrix)."""
    from dnn_mppi_mpc.ops.filters import apply_filter, filter_matrix

    rng = np.random.default_rng(7)
    x = rng.normal(size=(T, 2))
    ops = {
        "ma_edge": lambda z: moving_average_edge(z, w),
        "ma_padded": lambda z: moving_average_padded(z, w),
        "savgol": lambda z: savgol_filter(z, w, p),
    }
    want = np.asarray(ops[kind](jnp.asarray(x, jnp.float64)))
    F = filter_matrix(kind, T, w, p)
    np.testing.assert_allclose(F @ x, want, atol=1e-12)
    got = np.asarray(apply_filter(jnp.asarray(x, jnp.float64), kind, w, p))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_nearest_waypoint_window_semantics():
    path = np.stack(
        [np.linspace(0, 10, 101), np.zeros(101), np.zeros(101)], axis=1
    )
    idx, ref = nearest_waypoint(jnp.asarray(path), jnp.array([3.04, 0.1]), jnp.int32(20), 20)
    # window [20, 40) covers x in [2.0, 3.9]; nearest to 3.04 is x=3.0 → idx 30
    assert int(idx) == 30
    np.testing.assert_allclose(float(ref[0]), 3.0, atol=1e-6)


def test_nearest_waypoint_batched_and_clipped():
    path = np.stack([np.linspace(0, 10, 101), np.zeros(101), np.zeros(101)], axis=1)
    xy = jnp.asarray(np.random.default_rng(3).uniform(0, 10, size=(4, 7, 2)))
    idx, ref = nearest_waypoint(jnp.asarray(path), xy, jnp.int32(95), 20)
    assert idx.shape == (4, 7)
    assert ref.shape == (4, 7, 3)
    # window start must clip to P - W = 81
    assert int(jnp.min(idx)) >= 81


def test_circle_collision_indicator():
    obs = jnp.array([[5.0, 5.0, 1.0]])
    xy = jnp.array([[5.0, 6.2], [5.0, 6.6], [0.0, 0.0]])
    hit = np.asarray(circle_robot_collision(xy, obs, robot_radius=0.5))
    # robot radius 0.5 + obstacle 1.0 → collision iff dist < 1.5
    np.testing.assert_array_equal(hit, [1.0, 0.0, 0.0])


def test_polygon_collision_rotation_aware():
    obs = jnp.array([[4.0, 0.0, 1.0]])
    # vehicle 4 long, 3 wide, margin 1.5 → half-length 3.0: nose at x=3 from origin
    pose_hit = jnp.array([0.5, 0.0, 0.0, 0.0])
    pose_miss = jnp.array([-0.5, 0.0, jnp.pi / 2, 0.0])  # rotated: half-width 2.25 along x
    assert float(vehicle_polygon_collision(pose_hit, obs)) == 1.0
    assert float(vehicle_polygon_collision(pose_miss, obs)) == 0.0


def test_soft_obstacle_cost_matches_formula():
    obs = jnp.array([[1.0, 0.0]])
    xy = jnp.array([0.0, 0.0])
    got = float(soft_obstacle_cost(xy, obs, safety_distance=2.0, weight=100.0))
    np.testing.assert_allclose(got, 100.0 * np.exp(2.0 - 1.0), rtol=1e-5)


def test_control_energy_cost():
    sigma = jnp.array([[0.5, 0.0], [0.0, 0.1]])
    u = jnp.array([1.0, 2.0])
    v = jnp.array([0.5, -1.0])
    got = float(control_energy_cost(u, v, sigma_inverse(sigma), gamma=0.8))
    want = 0.8 * (1.0 / 0.5 * 0.5 + 2.0 / 0.1 * -1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_einsum_quadratic_cost():
    x = jnp.array([[1.0, 2.0, 3.0]])
    ref = jnp.zeros((1, 3))
    q = jnp.array([30.0, 5.0, 9.0])
    np.testing.assert_allclose(
        float(einsum_quadratic_cost(x, ref, q)[0]), 30 + 20 + 81, rtol=1e-6
    )


def test_sample_noise_covariance():
    sigma = jnp.array([[0.5, 0.1], [0.1, 0.2]])
    eps = sample_noise(jax.random.PRNGKey(0), sigma, 20000, 4)
    flat = np.asarray(eps).reshape(-1, 2)
    cov = np.cov(flat.T)
    np.testing.assert_allclose(cov, np.asarray(sigma), atol=0.02)
