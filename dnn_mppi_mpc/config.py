"""Typed configuration for the MPPI / NMPC framework.

The reference repo (SokhengDin/DNN-MPPI-MPC) hard-codes every hyperparameter as a
per-script ``__main__`` constant (e.g. ``controllers/mppi_differential_drive.py:392-443``).
Here configuration is split into

* **static config** — hashable frozen dataclasses that shape the compiled program
  (sample count K, horizon T, temperature convention, filter kind, ...). These are
  passed as ``static_argnums`` style arguments so XLA sees fixed shapes.
* **runtime params** — JAX pytrees of arrays (noise covariance, cost weights,
  reference path, obstacles) that can change between calls without recompilation.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class


class Temperature(enum.Enum):
    """Softmax inverse-temperature convention used when weighting samples.

    The reference uses two conventions:
    * ``LAMBDA``      — weight ∝ exp(-(S-ρ)/λ)            (mppi_race_car_obstacle.py:222-224)
    * ``EXPLORATION`` — weight ∝ exp(-(S-ρ)/exploration)  (mppi_differential_drive.py:175-178)
    """

    LAMBDA = "lambda"
    EXPLORATION = "exploration"


class CostAccumulation(enum.Enum):
    """Stage-cost accumulation over the horizon.

    ``SUM`` is the textbook MPPI accumulation (mppi_race_car_obstacle.py:94, ``+=``).
    ``LAST`` replicates the reference quirk at mppi_differential_drive.py:124 where
    ``S[k] =`` overwrites each step, leaving only the last stage cost (+ terminal).
    Only used for oracle-parity testing; ``SUM`` is the default.
    """

    SUM = "sum"
    LAST = "last"


class SmoothingFilter(enum.Enum):
    """Control-sequence smoothing filter applied to the weighted noise update.

    * ``MOVING_AVERAGE_EDGE``   — np.convolve 'same' with edge rescaling
      (mppi_differential_drive.py:257-271)
    * ``MOVING_AVERAGE_PADDED`` — edge-padded convolution
      (mppi_race_car_obstacle.py:228-239)
    * ``SAVGOL``                — Savitzky-Golay (test/test_mppi_diff_obs.py:275-300)
    * ``NONE``                  — no smoothing
    """

    MOVING_AVERAGE_EDGE = "ma_edge"
    MOVING_AVERAGE_PADDED = "ma_padded"
    SAVGOL = "savgol"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static (compile-time) MPPI solver configuration.

    Mirrors the hyperparameter surface of ``MPPIAlgorithms.__init__``
    (controllers/mppi_differential_drive.py:44-85) and
    ``MPPIRacecarController.__init__`` (controllers/mppi_race_car_obstacle.py:11-62),
    minus array-valued parameters which live in :class:`MPPIParams`.
    """

    num_samples: int  # K
    horizon: int  # T
    dim_x: int
    dim_u: int
    dt: float
    lam: float = 1.0  # λ, information-theoretic temperature
    alpha: float = 0.2  # α, decoupling of control-cost term; γ = λ(1-α)
    exploration: float = 0.0001  # fraction of pure-noise samples AND alt temperature
    temperature: Temperature = Temperature.LAMBDA
    accumulation: CostAccumulation = CostAccumulation.SUM
    filter: SmoothingFilter = SmoothingFilter.MOVING_AVERAGE_EDGE
    filter_window: int = 10
    savgol_polyorder: int = 3
    waypoint_search_len: int = 20  # SEARCH_IDX_LEN (mppi_differential_drive.py:204)
    num_rollout_repeats: int = 1  # M in pytorch_mppi (_compute_rollout_costs)
    rollout_var_cost: float = 0.0
    rollout_var_discount: float = 0.95
    waypoint_carry: str = "tick"  # nearest-waypoint window anchoring:
    # * "tick"    — one window per control tick (pure default; every rollout
    #   state queries the same [start, start+W) window)
    # * "rollout" — each rollout carries its own monotone window start through
    #   the scan (idx_{t+1} = argmin over [idx_t, idx_t+W)). This is the pure,
    #   vmappable form of the reference's *stateful* lookup
    #   (mppi_differential_drive.py:228 calls _get_nearest_waypoint with
    #   update_prev_idx=True from inside the cost): the mutation makes the
    #   window creep ahead of the robot during the solve and is what actually
    #   produces the reference demo's forward progress — the nearest-waypoint
    #   cost itself has no progress term. Supported by the scan path AND the
    #   GPU rollout kernel (per-sample carried index over a pre-gathered
    #   carry_window_len window; masked running-min).
    waypoint_persist: str = "none"  # cross-tick carry for "rollout" mode:
    # "none" keeps the tick-level window advance; "max" persists the furthest
    # rollout-carried index into the next tick's window start (the pure
    # analog of the reference's prev_way_point_idx retaining the last
    # sample's final index — measured to recover ~80% of the reference's
    # closed-loop progress where "none" recovers ~20%; tests/test_reference_crosscheck.py)
    carry_window_len: Optional[int] = None  # waypoint_carry="rollout" on the
    # rollout kernel: total pre-gathered window rows (must cover the furthest
    # index any rollout can reach from the tick anchor; the per-step search
    # span stays waypoint_search_len). None → waypoint_search_len + horizon
    # (advance ≤ ~1 waypoint/step). Too small silently truncates lookahead —
    # the scan-vs-kernel parity test (tests/test_waypoint_carry.py) is the
    # guard for a given problem's geometry.
    time_varying_dynamics: bool = False  # dynamics_step takes a third arg:
    # F(x, u, t) with t the int32 rollout step index (seconds = t·dt) — the
    # pytorch_mppi spec's `dynamics(states, actions, t)` signature
    # (test/test_mppi_diff_obs.py:28-42). The scan path and the rollout
    # kernel (step_takes_t, a tile step taking t) both support it.
    compute_optimal_traj: bool = False  # (T, nx) planned-trajectory diagnostic;
    # off by default: it is a K=1 *sequential* scan of T dependent steps whose
    # latency can rival the whole K-wide rollout and it serves
    # visualization only — enable for
    # plotting/animation (the reference's viz re-rollout,
    # mppi_differential_drive.py:144-149)

    @property
    def gamma(self) -> float:
        return self.lam * (1.0 - self.alpha)

    @property
    def inv_temperature(self) -> float:
        if self.temperature == Temperature.LAMBDA:
            return 1.0 / self.lam
        return 1.0 / self.exploration


@register_pytree_node_class
@dataclasses.dataclass
class MPPIParams:
    """Runtime (traced) MPPI parameters — a JAX pytree of arrays.

    ``sigma`` is the control noise covariance Σ (dim_u × dim_u); ``u_min``/``u_max``
    are the clamp bounds applied inside the rollout (``_g``,
    mppi_differential_drive.py:285-289); ``stage_weight``/``terminal_weight`` are the
    diagonal tracking weights; ``ref_path`` is the (P, dim_ref) waypoint table.
    """

    sigma: jnp.ndarray
    stage_weight: jnp.ndarray
    terminal_weight: jnp.ndarray
    u_min: jnp.ndarray
    u_max: jnp.ndarray
    ref_path: jnp.ndarray
    obstacles: Optional[jnp.ndarray] = None  # (n_obs, 3): x, y, radius
    obstacle_velocities: Optional[jnp.ndarray] = None  # (n_obs, 2): moving obstacles
    model_params: Optional[object] = None  # extra params for the dynamics fn
    # optional (nu,) diagonal action-cost weights: adds Σⱼ rⱼ·vⱼ² of the
    # CLAMPED per-step action to every stage cost — the ``control_cost``
    # term of the pytorch_mppi spec (test/test_mppi_diff_obs.py:48,
    # R = diag(0.1, 0.1)), which the engine's γ·uᵀΣ⁻¹v energy term does
    # not cover. None = no action cost (every other reference config).
    control_weight: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        children = (
            self.sigma,
            self.stage_weight,
            self.terminal_weight,
            self.u_min,
            self.u_max,
            self.ref_path,
            self.obstacles,
            self.obstacle_velocities,
            self.model_params,
            self.control_weight,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    """Static configuration of the SQP-RTI NMPC engine.

    JAX replacement for the acados solver options set at
    controllers/mpc_differential_drive_obstacle_static.py:236-247
    (FULL_CONDENSING_HPIPM / GAUSS_NEWTON / ERK / SQP_RTI,
    sim_method_num_stages=4, sim_method_num_steps=3).
    """

    N: int  # shooting intervals
    dim_x: int
    dim_u: int
    dt: float
    num_rk4_steps: int = 3  # ERK substeps per interval (sim_method_num_steps=3)
    integrator: str = "erk"  # 'erk' (RK4 substeps) or 'irk' (Gauss-Legendre
    # collocation w/ Newton — acados IRK, mpc_differential_dynamics.py:198;
    # A-stable for stiff torque/tire dynamics)
    irk_newton_iters: int = 3  # Newton steps on the IRK stage equations
    sqp_iters: int = 1  # 1 == SQP-RTI; >1 == converged SQP (mpc_racecar_casadi.py)
    qp_iters: int = 12  # interior-point iterations per QP solve
    n_h_constraints: int = 0  # nonlinear inequality constraints (obstacles)
    soft_h: bool = False  # soften h-constraints with slack penalties instead of
    # the hard barrier (the Zl/zl slack formulation of test_diff_mpc_dyna_slack.py)
    slack_weight_l2: float = 1.0e4  # L2 slack penalty (test_diff_mpc_dyna_slack.py:178-182)
    slack_weight_l1: float = 1.0e3
    ip_mu0: float = 1.0e-1  # initial interior-point barrier weight
    ip_kappa: float = 0.25  # barrier decrease factor per iteration
    ip_delta: float = 1.0e-3  # relaxed-barrier relaxation threshold δ: active
    # constraints settle at margin ≈ δ inside the bound (solvers/qp.py::
    # relaxed_barrier), so δ is the accuracy floor of the QP w.r.t. the exact
    # active-set solution. The f64 acados-parity gate (tests/test_oracle_nmpc.py)
    # shrinks it to 1e-6; the f32 hot path keeps 1e-3 (δ² stiffness must stay
    # representable and well-conditioned in f32).
    line_search: str = "merit"  # 'merit' (fixed-α ℓ1-merit globalization) or
    # 'full' — always take the full Newton step, acados' SQP_RTI semantics
    # (no globalization, mpc_differential_drive_obstacle_static.py:240)
    h_terminal: bool = True  # apply h-constraints at the terminal shooting node.
    # acados applies con_h_expr at stages 0..N-1 only (the reference never sets
    # con_h_expr_e, mpc_differential_drive_obstacle_static.py:211-234) — set
    # False for strict acados parity; True (default) also guards x_N.
    parallel_riccati: bool = True  # associative-scan (O(log N)-depth) Riccati
    # sweeps instead of sequential lax.scan — identical solution (FP reorder
    # only); the sequential path remains for reference/debugging
    qp_backend: Optional[str] = None  # 'xla' (scan Riccati) or 'pallas' (the
    # single-launch barrier-Riccati GPU kernel, ops/pallas/riccati_qp.py);
    # None picks by platform: the kernel on a GPU, XLA elsewhere


__all__ = [
    "Temperature",
    "CostAccumulation",
    "SmoothingFilter",
    "MPPIConfig",
    "MPPIParams",
    "SQPConfig",
]
