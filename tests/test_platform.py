"""The platform decision, the choice of kernel, and what the GPU compiler sees.

* ``utils.platform.platform()`` is the one place the program asks which
  machine it runs on: "gpu" or "cpu", anything else is an error.
* MPPISolver picks the rollout kernel on a GPU for problems the kernel
  implements and the scan path otherwise; NMPC picks the QP kernel on a GPU.
* Kernels run in the Pallas interpreter only when a caller asks.
* Both kernels lower for CUDA from this CPU-only process (Pallas → Triton
  IR), which catches what the Triton route refuses without a card.
* The compile cache honours ``JAX_COMPILATION_CACHE_DIR`` verbatim.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import dnn_mppi_mpc.solvers.mppi as mppi
import dnn_mppi_mpc.solvers.sqp as sqp
from dnn_mppi_mpc.config import MPPIConfig, MPPIParams, SQPConfig
from dnn_mppi_mpc.models import (
    dynamic_bicycle_tile,
    euler_step,
    four_wheel_torque_tile,
    kinematic_bicycle_tile,
    unicycle,
    unicycle_tile,
)
from dnn_mppi_mpc.utils import platform as plat

DT = 0.05


def _mppi(nx=3, nu=2, **kw):
    cfg = MPPIConfig(
        num_samples=96, horizon=6, dim_x=nx, dim_u=nu, dt=DT,
        waypoint_search_len=8, **kw,
    )
    step = lambda x, u: euler_step(unicycle, x, u, DT)
    return cfg, step


def _gpu(monkeypatch):
    monkeypatch.setattr(mppi, "platform", lambda: "gpu")
    monkeypatch.setattr(sqp, "platform", lambda: "gpu")


def test_platform_is_cpu_here():
    assert plat.platform() == "cpu"


def test_platform_rejects_other_backends(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        plat.platform()


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        plat.require_gpu()


def test_gpu_platform_picks_rollout_kernel(monkeypatch):
    _gpu(monkeypatch)
    cfg, step = _mppi()
    solver = mppi.MPPISolver(
        cfg, step, *mppi.make_tracking_costs(cfg), tile_dynamics=unicycle_tile(DT)
    )
    assert solver.rollout_fn is not None


def test_cpu_platform_picks_scan():
    cfg, step = _mppi()
    solver = mppi.MPPISolver(
        cfg, step, *mppi.make_tracking_costs(cfg), tile_dynamics=unicycle_tile(DT)
    )
    assert solver.rollout_fn is None


def test_use_pallas_false_overrides_gpu(monkeypatch):
    _gpu(monkeypatch)
    cfg, step = _mppi()
    solver = mppi.MPPISolver(
        cfg, step, *mppi.make_tracking_costs(cfg), use_pallas=False,
        tile_dynamics=unicycle_tile(DT),
    )
    assert solver.rollout_fn is None


@pytest.mark.parametrize("missing", ["tile", "costs", "repeats"])
def test_gpu_falls_back_to_scan_where_kernel_does_not_apply(monkeypatch, missing):
    """Learned/untiled dynamics, custom costs and M-repeat rollouts stay on
    the scan path on a GPU; use_pallas=True demands the kernel and says
    what is missing."""
    _gpu(monkeypatch)
    cfg, step = _mppi(num_rollout_repeats=2 if missing == "repeats" else 1)
    stage, terminal = mppi.make_tracking_costs(cfg)
    if missing == "costs":
        stage = lambda x, t, ctx: jnp.sum(x * x, axis=-1)
    tile = None if missing == "tile" else unicycle_tile(DT)
    solver = mppi.MPPISolver(cfg, step, stage, terminal, tile_dynamics=tile)
    assert solver.rollout_fn is None
    with pytest.raises(ValueError, match="rollout kernel needs"):
        mppi.MPPISolver(cfg, step, stage, terminal, use_pallas=True, tile_dynamics=tile)


def _pallas_call_params(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(eqn.params)
                continue
            for v in eqn.params.values():
                if hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
                    walk(v.jaxpr)
                elif hasattr(v, "eqns"):
                    walk(v)

    walk(jaxpr.jaxpr)
    return found


@pytest.mark.parametrize("interpret", [False, True])
def test_rollout_kernel_interprets_only_when_asked(interpret):
    cfg, step = _mppi()
    stage, terminal = mppi.make_tracking_costs(cfg)
    ro = mppi.make_rollout_kernel(
        cfg, unicycle_tile(DT), stage.tracking_spec, interpret=interpret
    )
    params = _params(3)
    noise = jnp.zeros((cfg.num_samples, cfg.horizon, 2), jnp.float32)
    calls = _pallas_call_params(
        lambda p, n: mppi.mppi_step(
            cfg, step, stage, terminal, p, mppi.MPPIState.init(cfg),
            jnp.zeros(3), n, rollout_fn=ro,
        ),
        params, noise,
    )
    assert len(calls) == 1
    assert bool(calls[0]["interpret"]) is interpret
    assert calls[0]["backend"] == "triton"


def _params(n_track, nu=2, obstacles=None):
    path = np.stack(
        [np.linspace(0, 4, 40), np.sin(np.linspace(0, 2, 40))]
        + [np.zeros(40)] * (n_track - 2), axis=1,
    )
    return MPPIParams(
        sigma=jnp.eye(nu, dtype=jnp.float32) * 0.1,
        stage_weight=jnp.ones(n_track, jnp.float32),
        terminal_weight=jnp.ones(n_track, jnp.float32),
        u_min=-jnp.ones(nu, jnp.float32),
        u_max=jnp.ones(nu, jnp.float32),
        ref_path=jnp.asarray(path, jnp.float32),
        obstacles=obstacles,
    )


_FAMILIES = {
    "unicycle": (3, 2, lambda: unicycle_tile(DT), {}),
    "kinematic_bicycle_polygon": (
        4, 2, lambda: kinematic_bicycle_tile(DT), dict(wrap_yaw=True, collision="polygon"),
    ),
    "four_wheel_circle": (5, 4, lambda: four_wheel_torque_tile(DT), dict(collision="circle")),
    "dynamic_bicycle_soft": (4, 2, lambda: dynamic_bicycle_tile(DT), dict(collision="soft")),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
@pytest.mark.parametrize("carry", [False, True])
def test_rollout_kernel_lowers_for_gpu(family, carry, f32_mode):
    """Each model family and cost mode lowers through Pallas' Triton route
    for CUDA (power-of-two blocks, supported primitives), here without a
    card — including the rollout-carried window and a vmapped fleet."""
    nx, nu, tile, cost_kw = _FAMILIES[family]
    cfg = MPPIConfig(
        num_samples=100, horizon=6, dim_x=nx, dim_u=nu, dt=DT,
        waypoint_search_len=40 if family == "kinematic_bicycle_polygon" else 8,
        waypoint_carry="rollout" if carry else "tick",
    )
    stage, terminal = mppi.make_tracking_costs(cfg, **cost_kw)
    ro = mppi.make_rollout_kernel(cfg, tile(), stage.tracking_spec, nx=nx)
    obstacles = None if cost_kw.get("collision", "none") == "none" else jnp.ones((2, 3))
    params = _params(min(nx, 4), nu, obstacles)
    step = lambda x, u: x  # the rollout never calls the XLA step

    def tick(p, x0):
        return mppi.mppi_step(
            cfg, step, stage, terminal, p, mppi.MPPIState.init(cfg), x0, rollout_fn=ro
        )[0]

    fleet = jax.vmap(tick, in_axes=(None, 0))
    text = jax.jit(fleet).trace(params, jnp.zeros((2, nx))).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert "xla.gpu.triton" in text


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_qp_kernel_lowers_for_gpu(dtype):
    from dnn_mppi_mpc.ops.pallas.riccati_qp import pallas_barrier_qp_solve
    from dnn_mppi_mpc.solvers.qp import BoxedQPData

    N, nx, nu = 6, 3, 2
    f = jnp.dtype(dtype)
    ones = lambda *s: jnp.ones(s, f)
    qp = BoxedQPData(
        A=ones(N, nx, nx), B=ones(N, nx, nu), c=ones(N, nx), Q=ones(N + 1, nx, nx),
        qx_base=ones(N + 1, nx), R=ones(N, nu, nu), ru_base=ones(N, nu),
        lbx=ones(N + 1, nx), ubx=ones(N + 1, nx), lbu=ones(N, nu), ubu=ones(N, nu),
        Jh=ones(N + 1, 1, nx), h0=ones(N + 1, 1), S=None,
    )
    text = jax.jit(lambda q, d: pallas_barrier_qp_solve(q, d)).trace(
        qp, ones(nx)
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text


def test_qp_backend_by_platform(monkeypatch):
    cfg = SQPConfig(N=4, dim_x=3, dim_u=2, dt=0.1)
    assert cfg.qp_backend is None
    assert sqp.qp_backend(cfg) == "xla"
    assert sqp.NMPCSolver(cfg, unicycle).cfg.qp_backend == "xla"
    _gpu(monkeypatch)
    assert sqp.qp_backend(cfg) == "pallas"
    assert sqp.NMPCSolver(cfg, unicycle).cfg.qp_backend == "pallas"
    # an explicit backend wins over the platform
    assert sqp.qp_backend(SQPConfig(N=4, dim_x=3, dim_u=2, dt=0.1, qp_backend="xla")) == "xla"


def test_qp_backend_rejects_unknown():
    with pytest.raises(ValueError, match="qp_backend"):
        sqp.qp_backend(SQPConfig(N=4, dim_x=3, dim_u=2, dt=0.1, qp_backend="mosaic"))


def test_compile_cache_env_used_verbatim(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    target = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    try:
        assert plat.enable_compilation_cache() == target
        assert jax.config.jax_compilation_cache_dir == target
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_default_is_checkout_dir(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        assert plat.enable_compilation_cache() == os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_chip_smoke_refuses_cpu(capsys):
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out
