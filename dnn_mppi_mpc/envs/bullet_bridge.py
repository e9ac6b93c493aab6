"""Host-side PyBullet bridge (optional — gated on pybullet availability).

Reproduces the structure of the reference's PyBullet deployment loops
(simulation/bullet_differential_drive_dnn.py:320-467,
controllers/bullet_mpc_race_car_obstacle.py:396-528): connect (GUI or DIRECT),
load URDF, then per tick read base pose → run the jitted controller → convert
to wheel commands → apply motor controls → step the physics.

PyBullet is host-side I/O: the controller itself stays a compiled JAX function
fed with a (3,)/(4,) state vector per tick, exactly like the real-robot path.

The engine module is resolved at *construction* time (``sys.modules`` first,
then a regular import), so tests inject
:mod:`..testing.mock_pybullet` as ``sys.modules["pybullet"]`` and execute
these classes end-to-end in CI without the real engine
(tests/test_bullet_bridge.py); when neither the real nor a mock engine is
present, construction raises a clear ImportError (pybullet is not part of
the baked build image).
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
from typing import Callable, Sequence

import numpy as np

from .kinematics import diff_drive_wheel_speeds


def _resolve_pybullet():
    """Return the (pybullet, pybullet_data) modules, honoring sys.modules
    injection (the mock path) before falling back to a real import."""
    try:
        p = sys.modules.get("pybullet") or importlib.import_module("pybullet")
        pd = sys.modules.get("pybullet_data") or importlib.import_module(
            "pybullet_data"
        )
    except ImportError as e:
        raise ImportError(
            "pybullet is not installed; the Bullet envs require it (or an "
            "injected mock — see testing.mock_pybullet). Use "
            "envs.plants.Plant / WheelPlant for the pure-JAX loop instead."
        ) from e
    return p, pd


def has_pybullet() -> bool:
    """True when a real or injected pybullet module is resolvable now."""
    return "pybullet" in sys.modules or (
        importlib.util.find_spec("pybullet") is not None
    )


def __getattr__(name: str):
    # Back-compat: HAS_PYBULLET evaluated dynamically so a mock injected
    # after this module's import is still seen.
    if name == "HAS_PYBULLET":
        return has_pybullet()
    raise AttributeError(name)


class BulletDiffDriveEnv:
    """Husky-style differential-drive robot in PyBullet.

    Mirrors simulation/bullet_differential_drive_dnn.py: 240 Hz physics
    (:365-366), wheel-velocity motor control through the diff-drive IK
    (:20-34, :453-456), optional moving cube obstacles (:398-408).
    """

    def __init__(
        self,
        urdf: str = "husky/husky.urdf",
        gui: bool = False,
        physics_hz: float = 240.0,
        wheel_joint_indices: Sequence[int] = (2, 3, 4, 5),
        max_wheel_force: float = 20.0,
    ) -> None:
        p, pybullet_data = _resolve_pybullet()
        self._p = p
        self.client = p.connect(p.GUI if gui else p.DIRECT)
        p.setAdditionalSearchPath(pybullet_data.getDataPath())
        p.setGravity(0, 0, -9.81)
        p.setTimeStep(1.0 / physics_hz)
        p.loadURDF("plane.urdf")
        self.robot = p.loadURDF(urdf, [0, 0, 0.1])
        self.wheel_joints = list(wheel_joint_indices)
        self.max_wheel_force = max_wheel_force
        self.physics_hz = physics_hz

    def get_state(self) -> np.ndarray:
        """(x, y, yaw) base state (the read at bullet_differential_drive_dnn.py:421-424)."""
        p = self._p
        pos, orn = p.getBasePositionAndOrientation(self.robot)
        yaw = p.getEulerFromQuaternion(orn)[2]
        return np.array([pos[0], pos[1], yaw])

    def apply_control(self, v: float, omega: float) -> None:
        p = self._p
        speeds = np.asarray(diff_drive_wheel_speeds(v, omega))
        for joint, s in zip(self.wheel_joints, speeds):
            p.setJointMotorControl2(
                self.robot,
                joint,
                p.VELOCITY_CONTROL,
                targetVelocity=float(s),
                force=self.max_wheel_force,
            )

    def step(self, n_substeps: int = 1) -> None:
        for _ in range(n_substeps):
            self._p.stepSimulation()

    def run(
        self,
        controller: Callable[[np.ndarray], np.ndarray],
        num_ticks: int,
        control_hz: float = 10.0,
    ) -> np.ndarray:
        """Closed loop: read state → controller → actuate → step physics."""
        substeps = max(1, int(self.physics_hz / control_hz))
        states = []
        for _ in range(num_ticks):
            x = self.get_state()
            u = np.asarray(controller(x))
            self.apply_control(float(u[0]), float(u[1]))
            self.step(substeps)
            states.append(x)
        return np.asarray(states)

    def close(self) -> None:
        self._p.disconnect(self.client)


class BulletAckermannEnv:
    """Racecar-style Ackermann vehicle in PyBullet.

    Mirrors controllers/bullet_mpc_race_car_obstacle.py:396-528: URDF joint
    discovery splits steering vs drive joints (:409-419), per-tick state read →
    jitted controller → Ackermann wheel IK (:384-394) → motor commands.
    """

    def __init__(
        self,
        urdf: str = "racecar/racecar.urdf",
        gui: bool = False,
        physics_hz: float = 240.0,
        wheel_base: float = 0.325,
        track_width: float = 0.2,
        max_force: float = 20.0,
    ) -> None:
        p, pybullet_data = _resolve_pybullet()
        self._p = p
        self.client = p.connect(p.GUI if gui else p.DIRECT)
        p.setAdditionalSearchPath(pybullet_data.getDataPath())
        p.setGravity(0, 0, -9.81)
        p.setTimeStep(1.0 / physics_hz)
        p.loadURDF("plane.urdf")
        self.robot = p.loadURDF(urdf, [0, 0, 0.05])
        self.wheel_base = wheel_base
        self.track_width = track_width
        self.max_force = max_force
        self.physics_hz = physics_hz
        # joint discovery by name (bullet_mpc_race_car_obstacle.py:409-419)
        self.steer_joints, self.drive_joints = [], []
        for j in range(p.getNumJoints(self.robot)):
            name = p.getJointInfo(self.robot, j)[1].decode()
            if "steering" in name:
                self.steer_joints.append(j)
            elif "wheel" in name:
                self.drive_joints.append(j)

    def get_state(self) -> np.ndarray:
        """(x, y, yaw, v) base state."""
        p = self._p
        pos, orn = p.getBasePositionAndOrientation(self.robot)
        yaw = p.getEulerFromQuaternion(orn)[2]
        lin, _ = p.getBaseVelocity(self.robot)
        v = float(np.hypot(lin[0], lin[1]))
        return np.array([pos[0], pos[1], yaw, v])

    def apply_control(self, steer: float, v: float) -> None:
        from .kinematics import ackermann_wheel_speeds

        p = self._p
        for j in self.steer_joints:
            p.setJointMotorControl2(
                self.robot, j, p.POSITION_CONTROL, targetPosition=float(steer)
            )
        speeds = np.asarray(
            ackermann_wheel_speeds(v, steer, self.wheel_base, self.track_width)
        )
        for j, s in zip(self.drive_joints, speeds):
            p.setJointMotorControl2(
                self.robot,
                j,
                p.VELOCITY_CONTROL,
                targetVelocity=float(s),
                force=self.max_force,
            )

    def step(self, n_substeps: int = 1) -> None:
        for _ in range(n_substeps):
            self._p.stepSimulation()

    def run(
        self,
        controller: Callable[[np.ndarray], np.ndarray],
        num_ticks: int,
        control_hz: float = 20.0,
    ) -> np.ndarray:
        """Closed loop: read state → controller(x) -> (steer, v) → actuate →
        step physics (bullet_mpc_race_car_obstacle.py:396-528)."""
        substeps = max(1, int(self.physics_hz / control_hz))
        states = []
        for _ in range(num_ticks):
            x = self.get_state()
            u = np.asarray(controller(x))
            self.apply_control(float(u[0]), float(u[1]))
            self.step(substeps)
            states.append(x)
        return np.asarray(states)

    def close(self) -> None:
        self._p.disconnect(self.client)


__all__ = [
    "BulletDiffDriveEnv",
    "BulletAckermannEnv",
    "HAS_PYBULLET",
    "has_pybullet",
]
