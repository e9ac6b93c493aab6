"""Path generation tests: splines vs scipy natural cubic, Bezier closed forms,
generator geometry."""

import numpy as np
import pytest
from scipy.interpolate import CubicSpline as ScipyCubic

from dnn_mppi_mpc.paths.bezier import (
    bezier_course_with_yaw,
    bezier_derivative_control_points,
    bernstein_matrix,
    calc_4points_bezier_path,
    calc_bezier_path,
    curvature,
)
from dnn_mppi_mpc.paths.generators import (
    circle_with_speed,
    lemniscate,
    lemniscate_with_speed,
    line,
)
from dnn_mppi_mpc.paths.splines import CubicSpline1D, CubicSpline2D, calc_spline_course


def test_cubic_spline_1d_matches_scipy_natural():
    x = np.array([0.0, 1.0, 2.5, 3.0, 5.0, 7.0])
    y = np.array([1.7, -6.0, 5.0, 6.5, 0.0, 2.0])
    ours = CubicSpline1D.fit(x, y)
    ref = ScipyCubic(x, y, bc_type="natural")
    xq = np.linspace(0.0, 7.0, 200)
    np.testing.assert_allclose(ours.position(xq), ref(xq), atol=1e-9)
    np.testing.assert_allclose(ours.first_derivative(xq), ref(xq, 1), atol=1e-9)
    np.testing.assert_allclose(ours.second_derivative(xq), ref(xq, 2), atol=1e-8)


def test_cubic_spline_2d_circle_curvature():
    t = np.linspace(0, 2 * np.pi, 60)
    R = 3.0
    sp = CubicSpline2D.fit(R * np.cos(t), R * np.sin(t))
    s_mid = np.linspace(sp.s[5], sp.s[-5], 50)
    np.testing.assert_allclose(sp.curvature(s_mid), 1.0 / R, rtol=6e-3)
    # yaw is tangent direction
    x, y = sp.position(s_mid)
    yaw = sp.yaw(s_mid)
    radial = np.arctan2(y, x)
    tang = radial + np.pi / 2
    diff = np.arctan2(np.sin(yaw - tang), np.cos(yaw - tang))
    np.testing.assert_allclose(diff, 0.0, atol=5e-3)


def test_calc_spline_course_spacing():
    rx, ry, ryaw, rk, s = calc_spline_course(
        [0.0, 2.0, 4.0, 6.0], [0.0, 1.0, -1.0, 0.0], ds=0.1
    )
    assert len(rx) == len(ry) == len(ryaw) == len(rk) == len(s)
    np.testing.assert_allclose(np.diff(s), 0.1, atol=1e-12)
    # passes near the knots
    d0 = np.min(np.hypot(np.asarray(rx) - 2.0, np.asarray(ry) - 1.0))
    assert d0 < 0.06


def test_bernstein_partition_of_unity():
    t = np.linspace(0, 1, 50)
    B = bernstein_matrix(3, t)
    np.testing.assert_allclose(B.sum(axis=1), 1.0, atol=1e-12)
    assert np.all(B >= 0)


def test_bezier_endpoints_and_linearity():
    cp = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])  # collinear
    path = calc_bezier_path(cp, 25)
    np.testing.assert_allclose(path[0], cp[0], atol=1e-12)
    np.testing.assert_allclose(path[-1], cp[-1], atol=1e-12)
    # collinear control points → straight line
    np.testing.assert_allclose(path[:, 1], path[:, 0], atol=1e-12)


def test_bezier_4points_heading():
    path, cp = calc_4points_bezier_path(0.0, 0.0, 0.0, 5.0, 3.0, np.pi / 2, 3.0)
    np.testing.assert_allclose(path[0], [0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(path[-1], [5.0, 3.0], atol=1e-12)
    # initial tangent along start yaw (=0): first step is +x
    step = path[1] - path[0]
    assert abs(step[1]) < abs(step[0]) * 0.01
    # final tangent along end yaw (=π/2): last step is +y
    step = path[-1] - path[-2]
    assert abs(step[0]) < abs(step[1]) * 0.01


def test_bezier_derivatives_and_curvature():
    # quadratic-ish circle approximation check of the curvature formula itself
    np.testing.assert_allclose(curvature(1.0, 0.0, 0.0, 2.0), 2.0)
    cp = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 1.0], [3.0, 3.0]])
    d = bezier_derivative_control_points(cp, 2)
    assert d[1].shape == (3, 2) and d[2].shape == (2, 2)
    np.testing.assert_allclose(d[1][0], 3 * (cp[1] - cp[0]))


def test_bezier_course_with_yaw():
    course = bezier_course_with_yaw(
        np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]]), 20
    )
    assert course.shape == (20, 3)
    np.testing.assert_allclose(course[:, 2], 0.0, atol=1e-12)  # straight → yaw 0


def test_generators_geometry():
    import jax.numpy as jnp

    ln = np.asarray(line(jnp.zeros(2), jnp.array([10.0, -5.0]), 50))
    np.testing.assert_allclose(ln[:, 2], np.arctan2(-5, 10))

    c = np.asarray(circle_with_speed(4.0, 100, speed=2.0))
    np.testing.assert_allclose(np.hypot(c[:, 0], c[:, 1]), 4.0, atol=1e-5)
    np.testing.assert_allclose(c[:, 3], 2.0)

    lem = np.asarray(lemniscate(8.0, 200))
    assert abs(lem[:, 0].max() - 8.0) < 0.1  # reaches ±a on the x axis
    np.testing.assert_allclose(lem[:, 1].mean(), 0.0, atol=0.05)

    lws = np.asarray(lemniscate_with_speed(8.0, 200, speed=5.0))
    assert lws.shape == (200, 4)
    np.testing.assert_allclose(lws[:, 3], 5.0)
