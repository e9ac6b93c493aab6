"""Drive the main path once on an NVIDIA GPU and check it against references.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --chips 4    # four GPUs: the sharded paths only

Phases (one process; any failure exits non-zero and prints no result):

1. device — JAX must run on a GPU; prints the card, its power limit, the JAX
   version and XLA_FLAGS.
2. flagship MPPI (diff-drive K=10 240, T=50, W=20) — 200 closed-loop ticks
   through ``MPPISolver`` on its default GPU path (the rollout kernel), then
   one tick on injected ε three ways (kernel, XLA scan on the GPU, scan on
   the CPU) and the kernel against the f64 ``OracleMPPI`` at K=512.
3. race-car MPPI (K=10 240, T=20, W=200, two obstacles, polygon collision) —
   the same checks against ``OracleRacecarMPPI``.
4. NMPC RTI (N=30, two obstacle rows) — a closed loop on the default GPU
   path (the QP kernel), per-tick lockstep against the f64
   ``oracle_nmpc.rti_tick`` on both QP backends, and the B=128 fleet against
   per-member XLA solves.
5. MPPI fleet (B=16, K=1 024, T=50) — the vmapped kernel tick against
   per-member scan ticks on the same keys.

Learned dynamics are not a phase: they need flax, which the GPU machine does
not have (ROADMAP.md).

With ``--chips 4`` only the sharded paths run, each against its one-card
twin: the sample-sharded tick at K=4×10 240, the sharded MPPI fleet and the
sharded NMPC fleet over a 1-D mesh of the four cards.

Precision: every comparison is f32 against f32 or f64, except the NMPC
lockstep, which runs f64 on the card against the f64 oracle. The MPPI energy,
weighted-noise and filter products and every NMPC product run at full f32
precision (``Precision.HIGHEST``).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from dnn_mppi_mpc import presets
from dnn_mppi_mpc.config import SQPConfig
from dnn_mppi_mpc.envs.closed_loop import mppi_controller, nmpc_controller, run_closed_loop
from dnn_mppi_mpc.models import kinematic_bicycle_tile, unicycle, unicycle_tile
from dnn_mppi_mpc.parallel.sharding import (
    make_sharded_mppi_fleet,
    make_sharded_mppi_step,
    make_sharded_nmpc_fleet,
)
from dnn_mppi_mpc.paths.generators import lemniscate_with_speed, line
from dnn_mppi_mpc.solvers.mppi import MPPISolver, make_rollout_kernel
from dnn_mppi_mpc.solvers.sqp import NMPCSolver, NMPCState, circle_obstacle_h
from dnn_mppi_mpc.testing import oracle_nmpc as onp
from dnn_mppi_mpc.testing.oracle import OracleMPPI, OracleRacecarMPPI
from dnn_mppi_mpc.utils.platform import enable_compilation_cache, platform

from __graft_entry__ import _flagship

FULL = dict(
    K=10_240, T=50, ticks=200, K_oracle=512,
    race_K=10_240, race_T=20, race_K_oracle=256,
    nmpc_N=30, nmpc_ticks=40, nmpc_B=128,
    fleet_B=16, fleet_K=1024, fleet_T=50,
)


class Checker:
    """Collects named comparisons; each prints its max error beside its
    tolerance and precision, and a failed one fails the run at the end."""

    def __init__(self):
        self.failed = []

    def close(self, name, got, ref, tol, precision, scale=True):
        got = np.asarray(got, np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {got.shape} != {ref.shape}")
        err = float(np.max(np.abs(got - ref))) if got.size else 0.0
        if scale:  # error relative to the reference's magnitude (≥ 1)
            err /= max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
        ok = bool(np.all(np.isfinite(got))) and err <= tol
        kind = "scaled" if scale else "abs"
        say(f"  {name}: max {kind} err {err:.3e} (tol {tol:.0e}, {precision}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(name)

    def true(self, name, cond, detail=""):
        say(f"  {name}: {'ok' if cond else 'FAIL'} {detail}")
        if not cond:
            self.failed.append(name)


def say(msg):
    print(msg, flush=True)


def _timed(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm-up
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _kernel_solver(cfg, step, stage, terminal, tile, interpret):
    """MPPISolver on its default path; in interpret mode (CPU rehearsal)
    the kernel is bound explicitly."""
    if interpret:
        ro = make_rollout_kernel(cfg, tile, stage.tracking_spec, interpret=True)
        return MPPISolver(cfg, step, stage, terminal, rollout_fn=ro)
    solver = MPPISolver(cfg, step, stage, terminal, tile_dynamics=tile)
    if solver.rollout_fn is None:
        raise AssertionError("MPPISolver did not choose the rollout kernel on the GPU")
    return solver


def _on_cpu(tree):
    return jax.device_put(tree, jax.devices("cpu")[0])


def _mppi_three_ways(chk, tag, kernel, scan, params, x0, eps, tol_S, tol_u):
    """One tick on injected ε: kernel vs scan on the accelerator vs scan on
    the CPU (f32 everywhere)."""
    st = kernel.init()
    out_k = kernel.step(params, st, x0, eps)
    out_s = scan.step(params, st, x0, eps)
    out_c = scan.step(_on_cpu(params), _on_cpu(st), _on_cpu(x0), _on_cpu(eps))
    for ref_name, ref in (("scan", out_s), ("cpu scan", out_c)):
        chk.close(f"{tag} kernel vs {ref_name} S", out_k[2].costs, ref[2].costs, tol_S, "f32")
        chk.close(f"{tag} kernel vs {ref_name} u0", out_k[0], ref[0], tol_u, "f32")
        chk.close(f"{tag} kernel vs {ref_name} u_prev", out_k[1].u_prev, ref[1].u_prev,
                  tol_u, "f32")


def phase_flagship(chk, s, interpret):
    say(f"[flagship MPPI] K={s['K']} T={s['T']} W=20")
    cfg, params, step, stage, terminal = _flagship(s["K"], s["T"])
    kernel = _kernel_solver(cfg, step, stage, terminal, unicycle_tile(cfg.dt), interpret)
    scan = MPPISolver(cfg, step, stage, terminal, use_pallas=False)
    x0 = jnp.zeros(3, jnp.float32)

    for name, solver in (("kernel", kernel), ("scan", scan)):
        run = jax.jit(lambda p, cs, x, solver=solver: run_closed_loop(
            mppi_controller(solver, p), step, cs, x, s["ticks"]))
        (episode, _), wall = _timed(run, params, solver.init(), x0)
        states = np.asarray(episode.states)
        say(f"  {name}: {s['ticks']} closed-loop ticks in {wall * 1e3:.3f} ms "
            f"({wall / s['ticks'] * 1e6:.3f} us/tick), final x={states[-1]}")
        chk.true(f"flagship {name} closed loop finite", bool(np.isfinite(states).all()))

    rng = np.random.default_rng(0)
    sigma = np.asarray(params.sigma, np.float64)
    eps = jnp.asarray(rng.multivariate_normal(np.zeros(2), sigma, (s["K"], s["T"])),
                      jnp.float32)
    x1 = jnp.asarray([0.3, -0.2, 0.1], jnp.float32)
    # S: f32 sums of T stage costs; u: the softmax at 1/exploration = 1e4
    # amplifies S rounding between near-best samples into the weights
    _mppi_three_ways(chk, "flagship", kernel, scan, params, x1, eps, 1e-5, 1e-3)

    Ko = s["K_oracle"]
    cfg_o, params_o, _, stage_o, terminal_o = _flagship(Ko, s["T"])
    k_o = _kernel_solver(cfg_o, step, stage_o, terminal_o, unicycle_tile(cfg.dt), interpret)
    oracle = OracleMPPI(ref_path=np.asarray(params.ref_path, np.float64), dt=cfg.dt,
                        K=Ko, T=s["T"], faithful=False)
    eps_o = rng.multivariate_normal(np.zeros(2), sigma, (Ko, s["T"]))
    u0_o, _, S_o = oracle.step(np.asarray(x1, np.float64), eps_o)
    u0, st, aux = k_o.step(params_o, k_o.init(), x1, jnp.asarray(eps_o, jnp.float32))
    chk.close(f"flagship kernel vs f64 oracle S (K={Ko})", aux.costs, S_o, 2e-4, "f32 vs f64")
    chk.close(f"flagship kernel vs f64 oracle u0 (K={Ko})", u0, u0_o, 1e-3, "f32 vs f64")
    chk.close(f"flagship kernel vs f64 oracle u_prev (K={Ko})", st.u_prev, oracle.u_prev,
              1e-3, "f32 vs f64")


def phase_racecar(chk, s, interpret):
    say(f"[race-car MPPI] K={s['race_K']} T={s['race_T']} W=200, 2 obstacles")
    ref = lemniscate_with_speed(10.0, 200, speed=5.0)
    obstacles = jnp.array([[5.0, 5.0, 1.0], [7.0, 7.0, 1.0]])

    def build(K, use_pallas):
        return presets.racecar_mppi(ref, num_samples=K, horizon=s["race_T"],
                                    obstacles=obstacles, use_pallas=use_pallas)

    kernel, params = build(s["race_K"], False if interpret else None)
    if interpret:
        kernel = _kernel_solver(kernel.cfg, kernel.dynamics_step,
                                *_racecar_costs(kernel.cfg), kinematic_bicycle_tile(0.05), True)
    elif kernel.rollout_fn is None:
        raise AssertionError("racecar preset did not choose the rollout kernel on the GPU")
    scan, _ = build(s["race_K"], False)
    x0 = ref[0].astype(jnp.float32)
    run = jax.jit(lambda p, cs, x: run_closed_loop(
        mppi_controller(kernel, p), kernel.dynamics_step, cs, x, s["ticks"]))
    (episode, _), wall = _timed(run, params, kernel.init(), x0)
    say(f"  kernel: {s['ticks']} closed-loop ticks in {wall * 1e3:.3f} ms")
    chk.true("racecar closed loop finite", bool(np.isfinite(np.asarray(episode.states)).all()))

    rng = np.random.default_rng(1)
    sigma = np.asarray(params.sigma, np.float64)
    eps = jnp.asarray(rng.multivariate_normal(np.zeros(2), sigma, (s["race_K"], s["race_T"])),
                      jnp.float32)
    x1 = jnp.asarray([10.0, 0.0, np.pi / 2, 3.0], jnp.float32)
    _mppi_three_ways(chk, "racecar", kernel, scan, params, x1, eps, 1e-5, 1e-3)

    Ko = s["race_K_oracle"]
    k_o, params_o = build(Ko, False if interpret else None)
    if interpret:
        k_o = _kernel_solver(k_o.cfg, k_o.dynamics_step, *_racecar_costs(k_o.cfg),
                             kinematic_bicycle_tile(0.05), True)
    oracle = OracleRacecarMPPI(ref_path=np.asarray(ref, np.float64), K=Ko, T=s["race_T"],
                               obstacles=np.asarray(obstacles, np.float64),
                               filter_window=k_o.cfg.filter_window)
    eps_o = rng.multivariate_normal(np.zeros(2), sigma, (Ko, s["race_T"]))
    u0_o, _, S_o = oracle.step(np.asarray(x1, np.float64), eps_o)
    u0, st, aux = k_o.step(params_o, k_o.init(), x1, jnp.asarray(eps_o, jnp.float32))
    chk.close(f"racecar kernel vs f64 oracle S (K={Ko})", aux.costs, S_o, 3e-4, "f32 vs f64")
    chk.close(f"racecar kernel vs f64 oracle u0 (K={Ko})", u0, u0_o, 1e-3, "f32 vs f64")
    chk.close(f"racecar kernel vs f64 oracle u_prev (K={Ko})", st.u_prev, oracle.u_prev,
              1e-3, "f32 vs f64")


def _racecar_costs(cfg):
    from dnn_mppi_mpc.solvers.mppi import make_tracking_costs

    return make_tracking_costs(cfg, wrap_yaw=True, collision="polygon")


def _nmpc_parity_cfg(N, backend):
    # the oracle's exact RTI semantics (tests/test_oracle_nmpc.py): full step,
    # no terminal h-row, a converged interior point with δ=1e-6 — in f64
    return SQPConfig(N=N, dim_x=3, dim_u=2, dt=0.1, sqp_iters=1, qp_iters=150,
                     ip_mu0=1e-1, ip_kappa=0.8, ip_delta=1e-6, line_search="full",
                     h_terminal=False, n_h_constraints=2, qp_backend=backend)


def phase_nmpc(chk, s, interpret):
    N = s["nmpc_N"]
    say(f"[NMPC RTI] N={N}, 2 obstacle rows; fleet B={s['nmpc_B']}")
    goal = jnp.array([3.0, 2.0, 0.0])
    obstacles = jnp.array([[1.5, 1.0, 0.3], [2.5, 1.8, 0.3]])
    backend = "pallas" if interpret else None
    solver, params = presets.diff_drive_nmpc(goal, N=N, obstacles=obstacles, sqp_iters=1,
                                             qp_backend=backend)
    if interpret:
        solver = NMPCSolver(solver.cfg, unicycle, h_fn=circle_obstacle_h, interpret=True)
    chk.true("nmpc default backend is the QP kernel", solver.cfg.qp_backend == "pallas",
             solver.cfg.qp_backend)
    x0 = jnp.zeros(3, jnp.float32)
    run = jax.jit(lambda p, cs, x: run_closed_loop(
        nmpc_controller(solver, p), solver.dyn_step, cs, x, s["ticks"]))
    (episode, _), wall = _timed(run, params, solver.init(x0), x0)
    states = np.asarray(episode.states)
    say(f"  kernel QP: {s['ticks']} closed-loop ticks in {wall * 1e3:.3f} ms, "
        f"final x={states[-1]}")
    chk.true("nmpc closed loop finite", bool(np.isfinite(states).all()))
    chk.true("nmpc closed loop approaches the goal",
             np.linalg.norm(states[-1, :2] - np.asarray(goal[:2]))
             < np.linalg.norm(np.asarray(goal[:2])))

    # per-tick lockstep against the f64 acados-semantics oracle
    p = {k: np.asarray(getattr(params, k), np.float64)
         for k in ("Q", "R", "Qe", "yref", "yref_e", "lbx", "ubx", "lbu", "ubu", "p")}
    ocp = onp.OracleOCP(N=N, dt=0.1, f=onp.unicycle_np, Q=p["Q"], R=p["R"], Qe=p["Qe"],
                        yref=p["yref"], yref_e=p["yref_e"], lbx=p["lbx"], ubx=p["ubx"],
                        lbu=p["lbu"], ubu=p["ubu"], h_fn=onp.circle_obstacle_h_np,
                        p=p["p"])
    rec = onp.closed_loop(ocp, np.zeros(3), ticks=s["nmpc_ticks"])
    # f64 on the card: in f32 this problem's ticks where the robot turns at
    # an obstacle are near-degenerate QPs whose f32 answers flip between
    # bound-active branches on either backend, so the algorithm is checked
    # in f64 (the QP kernel follows the problem's float type)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        for backend in ("xla", "pallas"):
            lock = NMPCSolver(_nmpc_parity_cfg(N, backend), unicycle, h_fn=circle_obstacle_h,
                              interpret=interpret and backend == "pallas")
            worst, n = 0.0, 0
            for t in range(s["nmpc_ticks"]):
                if rec["qp_viol"][t] > 1e-4:
                    continue  # infeasible linearized QP: no exact answer exists
                st = NMPCState(X=jnp.asarray(rec["warm_X"][t], jnp.float64),
                               U=jnp.asarray(rec["warm_U"][t], jnp.float64))
                u0, st2, _ = lock.solve(p64, st, jnp.asarray(rec["x"][t], jnp.float64))
                worst = max(worst, float(np.abs(np.asarray(u0) - rec["u0"][t]).max()),
                            float(np.abs(np.asarray(st2.U) - rec["U"][t]).max()),
                            float(np.abs(np.asarray(st2.X) - rec["X"][t]).max()))
                n += 1
            # 1e-3: the relaxed barrier's δ=1e-6 active-set offset
            # (tests/test_oracle_nmpc.py)
            chk.close(f"nmpc {backend} QP vs f64 oracle, lockstep over {n} ticks",
                      worst, 0.0, 1e-3, "f64 vs f64", scale=False)

    B = s["nmpc_B"]
    rng = np.random.default_rng(2)
    ang = rng.uniform(0, 2 * np.pi, B)
    goals = jnp.asarray(np.stack([3 * np.cos(ang), 3 * np.sin(ang), ang], 1), jnp.float32)
    obs = jnp.asarray(np.concatenate([0.55 * np.asarray(goals[:, :2]),
                                      np.full((B, 1), 0.25)], 1)[:, None, :], jnp.float32)
    x0s = jnp.asarray(rng.uniform(-0.3, 0.3, (B, 3)), jnp.float32)
    fleet_solver, base = presets.diff_drive_nmpc(jnp.zeros(3), N=N, obstacles=obs[0],
                                                 qp_backend=backend)
    if interpret:
        fleet_solver = NMPCSolver(fleet_solver.cfg, unicycle, h_fn=circle_obstacle_h,
                                  interpret=True)
    fparams = jax.vmap(lambda g, o: dataclasses.replace(
        base, yref=jnp.broadcast_to(jnp.concatenate([g, jnp.zeros(2)]), (N, 5)),
        yref_e=g, p=o))(goals, obs)
    states = jax.vmap(lambda x: NMPCState.init(fleet_solver.cfg, x))(x0s)
    (u_f, st_f, _), wall = _timed(fleet_solver.batched_solve(), fparams, states, x0s)
    say(f"  fleet B={B}: one tick in {wall * 1e3:.3f} ms")
    xla = NMPCSolver(dataclasses.replace(fleet_solver.cfg, qp_backend="xla"), unicycle,
                     h_fn=circle_obstacle_h)
    u_m = np.stack([np.asarray(xla.solve(jax.tree.map(lambda a: a[b], fparams),
                                         jax.tree.map(lambda a: a[b], states), x0s[b])[0])
                    for b in range(B)])
    # kernel and XLA Riccati differ in f32 summation order only
    chk.close(f"nmpc fleet B={B} kernel QP vs per-member XLA u0", u_f, u_m, 1e-3, "f32")


def phase_fleet(chk, s, interpret):
    B, K, T = s["fleet_B"], s["fleet_K"], s["fleet_T"]
    say(f"[MPPI fleet] B={B} K={K} T={T}")
    rng = np.random.default_rng(3)
    goals = rng.uniform(-4, 4, (B, 2)).astype(np.float32)
    paths = jnp.stack([line(jnp.zeros(2), jnp.asarray(g), num_points=80) for g in goals])
    kernel, params = presets.diff_drive_mppi(paths[0], num_samples=K, horizon=T, dt=0.05,
                                             use_pallas=False if interpret else None)
    if interpret:
        kernel = _kernel_solver(kernel.cfg, kernel.dynamics_step,
                                *_tracking(kernel.cfg), unicycle_tile(0.05), True)
    scan, _ = presets.diff_drive_mppi(paths[0], num_samples=K, horizon=T, dt=0.05,
                                      use_pallas=False)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    states = jax.vmap(kernel.init)(keys)
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 3)), jnp.float32)

    def fleet(p_paths, st, xs):
        return jax.vmap(lambda path, s1, x: kernel.step(
            dataclasses.replace(params, ref_path=path), s1, x))(p_paths, st, xs)

    (u_f, st_f, aux_f), wall = _timed(jax.jit(fleet), paths, states, x0s)
    say(f"  fleet tick in {wall * 1e3:.3f} ms")
    for b in range(B):
        pm = dataclasses.replace(params, ref_path=paths[b])
        sb = jax.tree.map(lambda a: a[b], states)
        u0, st, aux = scan.step(pm, sb, x0s[b])
        chk.close(f"fleet member {b} kernel vs scan u0", u_f[b], u0, 1e-3, "f32")
        chk.close(f"fleet member {b} kernel vs scan S", aux_f.costs[b], aux.costs, 1e-5,
                  "f32")


def _tracking(cfg):
    from dnn_mppi_mpc.solvers.mppi import make_tracking_costs

    return make_tracking_costs(cfg)


def phase_four_chips(chk, interpret=False, K1=10_240, T=50, B_mppi=16, K_fleet=1024,
                     B_nmpc=128, N=30):
    from jax.sharding import Mesh

    devices = jax.devices()
    n = len(devices)
    say(f"[sharded, {n} devices] sample-sharded tick K={n}x{K1}, MPPI fleet "
        f"B={n}x{B_mppi}, NMPC fleet B={B_nmpc}")
    mesh = Mesh(np.asarray(devices), ("k",))
    bmesh = Mesh(np.asarray(devices), ("batch",))

    cfg, params, step, stage, terminal = _flagship(n * K1, T)
    tile = unicycle_tile(cfg.dt)
    one = _kernel_solver(cfg, step, stage, terminal, tile, interpret)
    sharded = make_sharded_mppi_step(cfg, step, stage, terminal, mesh, rollout_fn=one.rollout_fn)
    rng = np.random.default_rng(5)
    eps = jnp.asarray(rng.multivariate_normal(np.zeros(2), np.asarray(params.sigma),
                                              (cfg.num_samples, T)), jnp.float32)
    x0 = jnp.asarray([0.3, -0.2, 0.1], jnp.float32)
    st = one.init()
    (u_s, st_s, aux_s), wall = _timed(sharded, params, st, x0, eps)
    say(f"  sharded tick in {wall * 1e3:.3f} ms")
    u_1, st_1, aux_1 = one.step(params, st, x0, eps)
    chk.close("sharded tick vs one-card S", aux_s.costs, aux_1.costs, 1e-5, "f32")
    chk.close("sharded tick vs one-card u0", u_s, u_1, 1e-3, "f32")
    chk.close("sharded tick vs one-card u_prev", st_s.u_prev, st_1.u_prev, 1e-3, "f32")

    B = n * B_mppi
    cfg_f, params_f, _, stage_f, terminal_f = _flagship(K_fleet, T)
    one_f = _kernel_solver(cfg_f, step, stage_f, terminal_f, tile, interpret)
    fleet = make_sharded_mppi_fleet(cfg_f, step, stage_f, terminal_f, bmesh, axis="batch",
                                    rollout_fn=one_f.rollout_fn)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    states = jax.vmap(one_f.init)(keys)
    x0s = jnp.asarray(rng.uniform(-0.5, 0.5, (B, 3)), jnp.float32)
    (u_f, _, aux_f), wall = _timed(fleet, params_f, states, x0s)
    say(f"  sharded MPPI fleet tick in {wall * 1e3:.3f} ms")
    u_r, _, aux_r = jax.jit(jax.vmap(lambda s1, x: one_f.step(params_f, s1, x)))(states, x0s)
    chk.close("sharded MPPI fleet vs one-card fleet u0", u_f, u_r, 1e-3, "f32")
    chk.close("sharded MPPI fleet vs one-card fleet S", aux_f.costs, aux_r.costs, 1e-5, "f32")

    obs = jnp.array([[1.0, 0.0, 0.3]])
    nsolver, base = presets.diff_drive_nmpc(jnp.zeros(3), N=N, obstacles=obs,
                                            qp_backend="pallas" if interpret else None)
    if interpret:
        nsolver = NMPCSolver(nsolver.cfg, unicycle, h_fn=circle_obstacle_h, interpret=True)
    ang = rng.uniform(0, 2 * np.pi, B_nmpc)
    goals = jnp.asarray(np.stack([3 * np.cos(ang), 3 * np.sin(ang), ang], 1), jnp.float32)
    fparams = jax.vmap(lambda g: dataclasses.replace(
        base, yref=jnp.broadcast_to(jnp.concatenate([g, jnp.zeros(2)]), (N, 5)),
        yref_e=g, p=obs))(goals)
    nx0 = jnp.asarray(rng.uniform(-0.3, 0.3, (B_nmpc, 3)), jnp.float32)
    nst = jax.vmap(lambda x: NMPCState.init(nsolver.cfg, x))(nx0)
    sfleet = make_sharded_nmpc_fleet(nsolver, bmesh, axis="batch")
    (u_n, _, _), wall = _timed(sfleet, fparams, nst, nx0)
    say(f"  sharded NMPC fleet tick in {wall * 1e3:.3f} ms")
    u_n1, _, _ = nsolver.batched_solve()(fparams, nst, nx0)
    chk.close("sharded NMPC fleet vs one-card fleet u0", u_n, u_n1, 1e-4, "f32")


def run_phases(s, interpret=False, chips=1):
    chk = Checker()
    if chips > 1:
        phase_four_chips(chk, interpret)
    else:
        phase_flagship(chk, s, interpret)
        phase_racecar(chk, s, interpret)
        phase_nmpc(chk, s, interpret)
        phase_fleet(chk, s, interpret)
    return chk


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    if platform() != "gpu":
        print(f"no GPU: JAX runs on {jax.default_backend()!r}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    devices = jax.devices()
    if len(devices) < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say("[device]")
    say(f"  {smi}")
    say(f"  jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    t0 = time.perf_counter()
    chk = run_phases(FULL, chips=args.chips)
    say(f"[done] {time.perf_counter() - t0:.1f} s, {len(chk.failed)} failed")
    if chk.failed:
        print("failed: " + ", ".join(chk.failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
