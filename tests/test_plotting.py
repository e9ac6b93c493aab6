"""Smoke tests for the headless plot/animation artifacts.

The animated closed-loop artifact is the reference's primary verification
output (FuncAnimation drivers, controllers/mppi_differential_drive.py:291-372
and models/vehicle.py:45-83); save_animation reproduces it headless (gif).
"""

import os

import numpy as np

from dnn_mppi_mpc.utils.plotting import (
    plot_controls,
    plot_trajectory,
    save_animation,
)


def _fake_run(n=12, T=6):
    t = np.linspace(0, 1, n)
    states = np.stack([t * 3.0, np.sin(t * 3.0), t], axis=1)
    ref = np.stack([t * 3.0, np.sin(t * 3.0)], axis=1)
    plans = np.stack(
        [np.stack([states[i, 0] + np.linspace(0, 0.5, T), states[i, 1] + 0.01 * np.arange(T)], axis=1) for i in range(n)]
    )
    return states, ref, plans


def test_save_animation_static_obstacles(tmp_path):
    states, ref, plans = _fake_run()
    out = tmp_path / "loop.gif"
    save_animation(
        str(out),
        states,
        ref_path=ref,
        planned_trajs=plans,
        obstacles=np.array([[1.0, 0.5, 0.3]]),
        fps=5,
    )
    assert out.exists() and out.stat().st_size > 1000


def test_save_animation_moving_obstacles_and_stride(tmp_path):
    states, ref, plans = _fake_run()
    obs_trajs = np.tile(np.array([[1.0, 0.5, 0.3], [2.0, -0.5, 0.2]]), (len(states), 1, 1))
    obs_trajs[:, 0, 0] += np.linspace(0, 1, len(states))
    out = tmp_path / "loop_moving.gif"
    save_animation(
        str(out),
        states,
        ref_path=ref,
        obstacle_trajs=obs_trajs,
        fps=5,
        stride=3,
    )
    assert out.exists() and out.stat().st_size > 1000


def test_static_plots(tmp_path):
    states, ref, _ = _fake_run()
    plot_trajectory(
        str(tmp_path / "traj.png"), states, ref_path=ref,
        obstacles=np.array([[1.0, 0.5, 0.3]]),
    )
    plot_controls(str(tmp_path / "ctrl.png"), np.random.randn(12, 2), 0.1, ["v", "w"])
    assert (tmp_path / "traj.png").exists() and (tmp_path / "ctrl.png").exists()


def test_racecar_four_pane_animation(tmp_path):
    """The 4-pane race-car layout (main chase view + minimap + steer/accel
    gauges — models/vehicle.py:45-83) renders headless to a gif."""
    from dnn_mppi_mpc.utils.plotting import save_racecar_animation

    t = np.linspace(0, 2 * np.pi, 12)
    states = np.stack([10 * np.cos(t), 10 * np.sin(t), t + np.pi / 2], axis=1)
    controls = np.stack([0.3 * np.sin(t), 1.5 * np.cos(t)], axis=1)
    ref = np.stack([10 * np.cos(t), 10 * np.sin(t)], axis=1)
    out = str(tmp_path / "race.gif")
    save_racecar_animation(out, states, controls, ref_path=ref, fps=4)
    assert os.path.getsize(out) > 1000
