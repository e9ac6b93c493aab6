"""pytorch_mppi parity features: moving obstacles in rollout, M-repeat variance,
Savitzky-Golay smoothing mode, top-p%% trajectory extraction."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc.config import (
    MPPIConfig,
    MPPIParams,
    SmoothingFilter,
    Temperature,
)
from dnn_mppi_mpc.models.dynamics import unicycle
from dnn_mppi_mpc.models.integrators import euler_step
from dnn_mppi_mpc.solvers.mppi import (
    MPPISolver,
    MPPIState,
    make_tracking_costs,
    sampled_trajectories,
)

K, T, DT = 128, 10, 0.05


def _base(**over):
    kw = dict(
        num_samples=K,
        horizon=T,
        dim_x=3,
        dim_u=2,
        dt=DT,
        lam=1.0,
        temperature=Temperature.LAMBDA,
        filter=SmoothingFilter.NONE,
        waypoint_search_len=20,
    )
    kw.update(over)
    cfg = MPPIConfig(**kw)
    path = np.stack(
        [np.linspace(0, 10, 100), np.zeros(100), np.zeros(100)], axis=1
    ).astype(np.float32)
    params = MPPIParams(
        sigma=jnp.eye(2) * 0.3,
        stage_weight=jnp.array([5.0, 5.0, 1.0]),
        terminal_weight=jnp.array([5.0, 5.0, 1.0]),
        u_min=jnp.array([-3.0, -3.0]),
        u_max=jnp.array([3.0, 3.0]),
        ref_path=jnp.asarray(path),
    )
    return cfg, params


def test_moving_obstacles_shift_costs():
    """An obstacle drifting into the path must raise rollout costs relative to
    the same obstacle held static (test_mppi_diff_obs.py:14-20 semantics)."""
    cfg, params = _base()
    stage, terminal = make_tracking_costs(cfg, collision="soft", soft_weight=1000.0)
    solver = MPPISolver(cfg, lambda x, u: euler_step(unicycle, x, u, DT), stage, terminal)
    eps = jnp.zeros((K, T, 2))
    state = MPPIState(
        u_prev=jnp.tile(jnp.array([3.0, 0.0]), (T, 1)),
        waypoint_idx=jnp.int32(0),
        key=jax.random.PRNGKey(0),
    )
    # obstacle starts off-path ahead, drifting INTO the path
    params_static = dataclasses.replace(params, obstacles=jnp.array([[1.0, 2.1, 0.0]]))
    params_moving = dataclasses.replace(
        params_static, obstacle_velocities=jnp.array([[0.0, -6.0]])
    )
    _, _, aux_s = solver.step(params_static, state, jnp.zeros(3), noise=eps)
    _, _, aux_m = solver.step(params_moving, state, jnp.zeros(3), noise=eps)
    assert float(aux_m.costs.mean()) > float(aux_s.costs.mean()) + 1.0


def test_m_repeat_variance_cost_with_stochastic_dynamics():
    """M>1 repeats with a stochastic plant: variance cost must be positive and
    raise the cost of samples traversing the noisy region."""
    cfg, params = _base(num_rollout_repeats=4, rollout_var_cost=10.0)
    stage, terminal = make_tracking_costs(cfg)

    def stoch_step(x, u):
        # pseudo-stochastic: each of the M repeats sees a different drift,
        # keyed off its repeat index via the leading axis values
        x2 = euler_step(unicycle, x, u, DT)
        if x.ndim == 3:  # (M, K, nx)
            m_idx = jnp.arange(x.shape[0], dtype=x.dtype)[:, None, None]
            x2 = x2 + 0.01 * m_idx
        return x2

    solver = MPPISolver(cfg, stoch_step, stage, terminal)
    state = solver.init()
    u0, st, aux = solver.step(params, state, jnp.zeros(3))
    assert aux.costs.shape == (K,)
    assert np.all(np.isfinite(np.asarray(aux.costs)))

    # deterministic M-repeat must equal M=1 exactly
    cfg1, _ = _base()
    det = lambda x, u: euler_step(unicycle, x, u, DT)
    s1 = MPPISolver(cfg1, det, *make_tracking_costs(cfg1))
    cfgM, _ = _base(num_rollout_repeats=3, rollout_var_cost=5.0)
    sM = MPPISolver(cfgM, det, *make_tracking_costs(cfgM))
    eps = jax.random.normal(jax.random.PRNGKey(1), (K, T, 2)) * 0.2
    _, _, a1 = s1.step(params, s1.init(), jnp.zeros(3), noise=eps)
    _, _, aM = sM.step(params, sM.init(), jnp.zeros(3), noise=eps)
    np.testing.assert_allclose(np.asarray(aM.costs), np.asarray(a1.costs), rtol=1e-5)


def test_savgol_filter_mode_runs():
    cfg, params = _base(filter=SmoothingFilter.SAVGOL, filter_window=7, savgol_polyorder=3)
    stage, terminal = make_tracking_costs(cfg)
    solver = MPPISolver(cfg, lambda x, u: euler_step(unicycle, x, u, DT), stage, terminal)
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(u0)))


def test_top_fraction_trajectory_extraction():
    """Top-10% extraction (test_mppi_diff_obs.py:102-110): returned trajs are
    the lowest-cost ones, ordered best-first."""
    cfg, params = _base()
    stage, terminal = make_tracking_costs(cfg)
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    solver = MPPISolver(cfg, step_fn, stage, terminal)
    state = solver.init()
    eps = jax.random.normal(jax.random.PRNGKey(2), (K, T, 2)) * 0.3
    _, _, aux = solver.step(params, state, jnp.zeros(3), noise=eps)
    trajs = solver.sampled_trajectories(
        params, state, jnp.zeros(3), eps, aux.costs, top_fraction=0.1
    )
    assert trajs.shape == (K // 10, T, 3)
    assert np.all(np.isfinite(np.asarray(trajs)))


def test_status_flags_end_of_path_and_nonfinite():
    """Failure detection (SURVEY §5.3): end-of-path flag and non-finite guard."""
    cfg, params = _base()
    stage, terminal = make_tracking_costs(cfg)
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    solver = MPPISolver(cfg, step_fn, stage, terminal)

    # normal tick: status 0
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3))
    assert int(aux.status) == 0

    # robot at the far end of the path → end-of-path bit set
    x_end = jnp.array([10.0, 0.0, 0.0])
    st = solver.init()
    import dataclasses as dc
    st = dc.replace(st, waypoint_idx=jnp.int32(params.ref_path.shape[0] - 2))
    u0, st2, aux = solver.step(params, st, x_end)
    assert int(aux.status) & 1

    # NaN state → non-finite bit set and previous sequence held
    st3 = solver.init()
    u_prev_before = np.asarray(st3.u_prev)
    u0, st4, aux = solver.step(params, st3, jnp.array([jnp.nan, 0.0, 0.0]))
    assert int(aux.status) & 2
    # shifted previous sequence (still finite)
    assert np.all(np.isfinite(np.asarray(st4.u_prev)))
    assert np.all(np.isfinite(np.asarray(u0)))


def test_nmpc_status_nonfinite_guard():
    from dnn_mppi_mpc.config import SQPConfig
    from dnn_mppi_mpc.solvers.sqp import NMPCSolver, OCPParams

    N = 8
    cfg = SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=8)
    solver = NMPCSolver(cfg, unicycle)
    goal = jnp.array([1.0, 0.5, 0.0])
    params = OCPParams(
        Q=jnp.eye(3), R=jnp.eye(2) * 0.1, Qe=jnp.eye(3),
        yref=jnp.concatenate([goal, jnp.zeros(2)])[None, :].repeat(N, axis=0),
        yref_e=goal,
        lbx=jnp.full(3, -10.0), ubx=jnp.full(3, 10.0),
        lbu=jnp.full(2, -1.0), ubu=jnp.full(2, 1.0),
    )
    st = solver.init(jnp.zeros(3))
    u0, st2, aux = solver.solve(params, st, jnp.zeros(3))
    assert int(aux.status) == 0
    u0, st3, aux = solver.solve(params, st2, jnp.array([jnp.nan, 0.0, 0.0]))
    assert int(aux.status) == 2
    assert np.all(np.isfinite(np.asarray(u0)))


def test_solver_forwards_collision_to_fused_tick(monkeypatch):
    """The kernel MPPISolver builds gets the bound costs' own constants
    (collision mode, soft distance and weight) — a kernel on default
    settings would silently compute another cost than the scan path."""
    import dnn_mppi_mpc.solvers.mppi as m
    from dnn_mppi_mpc.models import euler_step, unicycle, unicycle_tile

    cfg = MPPIConfig(
        num_samples=128, horizon=8, dim_x=3, dim_u=2, dt=0.05,
        waypoint_search_len=4,
    )
    step_fn = lambda x, u: euler_step(unicycle, x, u, cfg.dt)
    stage, terminal = m.make_tracking_costs(
        cfg, collision="soft", soft_safety_distance=1.5, soft_weight=50.0
    )

    captured = {}

    def fake_factory(cfg_, tile, spec, **kw):
        captured["spec"] = spec
        return lambda *a, **k: None

    monkeypatch.setattr(m, "platform", lambda: "gpu")
    monkeypatch.setattr(m, "make_rollout_kernel", fake_factory)
    m.MPPISolver(cfg, step_fn, stage, terminal, tile_dynamics=unicycle_tile(cfg.dt))
    assert captured["spec"].collision == "soft"
    assert captured["spec"].soft_safety_distance == 1.5
    assert captured["spec"].soft_weight == 50.0


def test_mppi_step_accepts_non_array_model_params():
    """MPPIParams.model_params is Optional[object]; a Python-scalar leaf must
    not crash the tick's dtype unification (round-2 review finding)."""
    from dnn_mppi_mpc.models import euler_step, unicycle
    from dnn_mppi_mpc.solvers.mppi import (
        MPPISolver,
        MPPIState,
        make_tracking_costs,
    )

    cfg = MPPIConfig(
        num_samples=64, horizon=6, dim_x=3, dim_u=2, dt=0.05,
        waypoint_search_len=4,
    )
    gain = 0.9  # plain float rides in model_params

    def step_fn(x, u, g=gain):
        return euler_step(unicycle, x, u * g, cfg.dt)

    stage, terminal = make_tracking_costs(cfg)
    params = MPPIParams(
        sigma=jnp.eye(2) * 0.1,
        stage_weight=jnp.array([5.0, 5.0, 1.0]),
        terminal_weight=jnp.array([5.0, 5.0, 1.0]),
        u_min=jnp.array([-2.0, -2.0]),
        u_max=jnp.array([2.0, 2.0]),
        ref_path=jnp.zeros((10, 3)),
        model_params=0.5,  # non-array pytree leaf
    )
    solver = MPPISolver(cfg, step_fn, stage, terminal)
    u0, st, aux = solver.step(params, solver.init(), jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(u0)))


def test_control_weight_adds_exact_action_cost():
    """params.control_weight adds EXACTLY Σ_t Σ_j r_j·v²_{k,t,j} of the
    clamped action to each sample's cost — the pytorch_mppi spec's
    control_cost = aᵀ·diag(R)·a (test/test_mppi_diff_obs.py:48-53). Verified
    against a hand-computed term (parity between engine paths alone would
    cancel a shared sign/factor error), on both the scan path and the
    rollout kernel (interpret mode)."""
    import dataclasses as _dc

    from dnn_mppi_mpc.models import unicycle_tile
    from dnn_mppi_mpc.solvers.mppi import (
        MPPIState,
        make_rollout_kernel,
        mppi_step,
    )

    cfg, params = _base(exploration=0.25)
    stage, terminal = make_tracking_costs(cfg)
    rng = np.random.default_rng(5)
    eps = jnp.asarray(rng.normal(0, 0.8, (K, T, 2)), jnp.float32)
    x0 = jnp.array([0.0, 0.3, 0.1], jnp.float32)
    step_fn = lambda x, u: euler_step(unicycle, x, u, DT)
    cw = jnp.array([0.1, 0.07], jnp.float32)
    params_cw = _dc.replace(params, control_weight=cw)

    state = MPPIState.init(cfg)
    state = _dc.replace(
        state,
        u_prev=jnp.asarray(rng.normal(0, 0.4, (T, 2)), jnp.float32),
    )

    # hand-computed clamped actions and the exact expected term
    u_np = np.asarray(state.u_prev)
    eps_np = np.asarray(eps)
    k_idx = np.arange(K)
    exploit = (k_idx < (1.0 - cfg.exploration) * K)[:, None, None]
    v = np.where(exploit, u_np[None] + eps_np, eps_np)
    v = np.clip(v, np.asarray(params.u_min), np.asarray(params.u_max))
    expected = np.einsum("ktj,j->k", v.astype(np.float64) ** 2, np.asarray(cw))

    for maker in ("scan", "tick"):
        tick = (
            make_rollout_kernel(
                cfg, unicycle_tile(DT), stage.tracking_spec, interpret=True
            )
            if maker == "tick"
            else None
        )
        run = lambda p: mppi_step(
            cfg, step_fn, stage, terminal, p, state, x0, eps, rollout_fn=tick
        )
        _, _, aux_base = jax.jit(run)(params)
        _, _, aux_cw = jax.jit(run)(params_cw)
        got = np.asarray(aux_cw.costs, np.float64) - np.asarray(
            aux_base.costs, np.float64
        )
        np.testing.assert_allclose(
            got, expected, rtol=1e-4, atol=1e-3,
            err_msg=f"action-cost term wrong on the {maker} path",
        )
