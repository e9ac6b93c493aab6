"""Command-line interface: ``python -m dnn_mppi_mpc <command>``.

The reference has no CLI layer at all — every experiment is an
``if __name__ == "__main__"`` script with hard-coded constants (SURVEY §1;
e.g. controllers/mppi_differential_drive.py:392-443, and its hyperparameters
at :399-410 can only be changed by editing the file). This module gives the
framework one typed entry point over the preset layer:

    python -m dnn_mppi_mpc info
    python -m dnn_mppi_mpc demo diff-drive-mppi --ticks 300 --out /tmp/d
    python -m dnn_mppi_mpc demo racecar-nmpc --ticks 100
    python -m dnn_mppi_mpc bench --k 10240 --t 50
    python -m dnn_mppi_mpc collect --series 8 --ticks 200 --out data.npz
    python -m dnn_mppi_mpc train --data data.npz --model mlp --ckpt /tmp/ck

Every command prints ONE machine-readable JSON line as its last stdout line
(human-readable progress goes to stderr), so the CLI composes into shell
pipelines and CI checks. Demos run controller + plant as a single on-device
``lax.scan`` (envs/closed_loop.run_closed_loop) — the host only sees the
finished episode.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _emit(payload: dict) -> None:
    print(json.dumps(payload), flush=True)


# ---------------------------------------------------------------------------
# info


def cmd_info(args: argparse.Namespace) -> None:
    from . import __version__

    devices = jax.devices()
    _emit(
        {
            "version": __version__,
            "backend": jax.default_backend(),
            "devices": [str(d) for d in devices],
            "device_count": len(devices),
            "demos": sorted(_DEMOS),
            "commands": ["info", "demo", "bench", "collect", "train"],
        }
    )


# ---------------------------------------------------------------------------
# demo


def _line_path(n: int = 200):
    from .paths.generators import line

    return line(jnp.zeros(2), jnp.array([8.0, -4.0]), n)


def _demo_diff_drive_mppi(args):
    from . import presets

    obstacles = (
        jnp.array([[3.0, -1.0, 0.8], [5.5, -3.0, 0.8]]) if args.obstacles else None
    )
    lookahead = (
        dict(waypoint_carry="rollout", waypoint_persist="max")
        if args.lookahead
        else {}
    )
    solver, params = presets.diff_drive_mppi(
        _line_path(),
        num_samples=args.samples,
        horizon=args.horizon,
        obstacles=obstacles,
        compute_optimal_traj=False,
        **lookahead,
    )
    return solver, params, "mppi", jnp.zeros(3), obstacles


def _demo_racecar_mppi(args):
    from . import presets
    from .paths.generators import circle_with_speed

    ref = circle_with_speed(radius=20.0, speed=5.0, num_points=400)
    solver, params = presets.racecar_mppi(
        ref,
        num_samples=args.samples,
        horizon=max(args.horizon, 20),
        compute_optimal_traj=False,
    )
    x0 = jnp.array([20.0, 0.0, jnp.pi / 2, 2.0])
    return solver, params, "mppi", x0, None


def _demo_goal_seeking_mppi(args):
    from . import presets

    solver, params = presets.goal_seeking_mppi(
        jnp.array([6.0, 6.0, 0.0]),
        num_samples=args.samples,
        horizon=max(args.horizon, 25),
    )
    return solver, params, "mppi", jnp.zeros(3), getattr(params, "obstacles", None)


def _demo_diff_drive_nmpc(args):
    from . import presets

    obstacles = jnp.array([[2.0, 1.2, 0.7]]) if args.obstacles else None
    solver, params = presets.diff_drive_nmpc(
        jnp.array([4.0, 2.5, 0.0]), obstacles=obstacles
    )
    return solver, params, "nmpc", jnp.zeros(3), obstacles


def _demo_racecar_nmpc(args):
    from . import presets

    solver, params = presets.racecar_nmpc(jnp.array([5.0, 3.0, 0.0, 0.0]))
    return solver, params, "nmpc", jnp.zeros(4), None


def _demo_four_wheel_nmpc(args):
    from . import presets

    solver, params = presets.four_wheel_nmpc(jnp.array([2.0, 1.0, 0.0, 0.0, 0.0]))
    return solver, params, "nmpc", jnp.zeros(5), None


_DEMOS = {
    "diff-drive-mppi": _demo_diff_drive_mppi,
    "racecar-mppi": _demo_racecar_mppi,
    "goal-seeking-mppi": _demo_goal_seeking_mppi,
    "diff-drive-nmpc": _demo_diff_drive_nmpc,
    "racecar-nmpc": _demo_racecar_nmpc,
    "four-wheel-nmpc": _demo_four_wheel_nmpc,
}


def cmd_demo(args: argparse.Namespace) -> None:
    from .envs.closed_loop import mppi_controller, nmpc_controller, run_closed_loop

    solver, params, kind, x0, obstacles = _DEMOS[args.name](args)
    dt = float(solver.cfg.dt)
    if kind == "mppi":
        make_controller = lambda p: mppi_controller(solver, p)
        cs0 = solver.init(jax.random.PRNGKey(args.seed))
        ref_path = np.asarray(params.ref_path) if params.ref_path is not None else None
        # goal distance only makes sense for open courses (a circular course's
        # endpoint is its start — cross-track error is the metric there); a
        # single-row path is a goal pose (the goal-seeking preset)
        target = None
        if ref_path is not None and (
            len(ref_path) == 1
            or np.linalg.norm(ref_path[0, :2] - ref_path[-1, :2]) > 1e-3
        ):
            target = ref_path[-1, :2]
    else:
        make_controller = lambda p: nmpc_controller(solver, p)
        cs0 = solver.init(x0)
        ref_path = None
        target = np.asarray(params.yref_e[:2])

    plant = solver.dynamics_step if kind == "mppi" else solver.dyn_step
    # params rides through jit as an ARGUMENT and the controller factory
    # binds the tracer, so the program is the one a deployment compiles
    run = jax.jit(
        lambda p, cs, x: run_closed_loop(make_controller(p), plant, cs, x, args.ticks)
    )
    jax.block_until_ready(run(params, cs0, x0))  # compile + warm-up
    t0 = time.perf_counter()
    episode, _ = jax.block_until_ready(run(params, cs0, x0))
    wall = time.perf_counter() - t0

    states = np.asarray(episode.states)
    controls = np.asarray(episode.controls)
    # Tracking MPPI has no progress term (mppi_differential_drive.py stage
    # cost tracks the NEAREST waypoint), so — exactly like the reference demo,
    # which runs 1000 frames for an 11 m course — report progress toward the
    # goal plus cross-track error, not arrival.
    start_err = final_err = None
    if target is not None:
        start_err = float(np.linalg.norm(states[0, :2] - target))
        final_err = float(np.linalg.norm(states[-1, :2] - target))
    cross_track = None
    if ref_path is not None:
        d = np.linalg.norm(ref_path[None, :, :2] - states[:, None, :2], axis=-1)
        cross_track = float(d.min(axis=1).max())  # worst nearest-path distance
    artifacts = []
    if args.out:
        import os

        from .utils.plotting import plot_controls, plot_trajectory

        os.makedirs(args.out, exist_ok=True)
        traj_png = os.path.join(args.out, f"{args.name}_trajectory.png")
        ctrl_png = os.path.join(args.out, f"{args.name}_controls.png")
        plot_trajectory(
            traj_png, states, ref_path=ref_path, obstacles=obstacles, title=args.name
        )
        plot_controls(ctrl_png, controls, dt)
        artifacts = [traj_png, ctrl_png]
        _say(f"wrote {traj_png}, {ctrl_png}")

    _emit(
        {
            "demo": args.name,
            "kind": kind,
            "ticks": args.ticks,
            "dt": dt,
            "goal_distance_start_m": start_err,
            "goal_distance_final_m": final_err,
            "cross_track_error_max_m": cross_track,
            "mean_speed": float(np.abs(controls[:, 0]).mean()),
            "wall_s": round(wall, 4),
            "ticks_per_s": round(args.ticks / wall, 1),
            "realtime_factor": round(args.ticks * dt / wall, 1),
            "finite": bool(np.isfinite(states).all()),
            "artifacts": artifacts,
        }
    )


# ---------------------------------------------------------------------------
# bench


def cmd_bench(args: argparse.Namespace) -> None:
    """Chained-tick MPPI solves/s through the preset layer, on a GPU."""
    from . import presets
    from .utils.benchtime import chain_timing, scan_chain_runner
    from .utils.platform import require_gpu

    require_gpu()
    solver, params = presets.diff_drive_mppi(
        _line_path(), num_samples=args.k, horizon=args.t, dt=0.02,
        compute_optimal_traj=False,
    )
    step_fn = solver.dynamics_step

    def body(params, state, x):
        u0, state, aux = solver._step(params, state, x, None)
        return (state, step_fn(x, u0)), aux.costs[0]

    st0, x0 = solver.init(), jnp.zeros(3, jnp.float32)
    timing = chain_timing(
        lambda n: scan_chain_runner(body, params, st0, x0, n), 1000, 20
    )
    dev = jax.devices()[0]
    _emit(
        {
            "metric": f"mppi_solves_per_s_K{solver.cfg.num_samples}_T{args.t}",
            "value": timing.ticks_per_s,
            "unit": "solves/s",
            "per_solve_ms_best": timing.best * 1e3,
            "p50_ms": timing.p50 * 1e3,
            "p99_ms": timing.p99 * 1e3,
            "path": "kernel" if solver.rollout_fn is not None else "xla_scan",
            "platform": dev.platform,
            "device_kind": dev.device_kind,
        }
    )


# ---------------------------------------------------------------------------
# collect


def cmd_collect(args: argparse.Namespace) -> None:
    """Randomized-series residual-dataset collection → .npz triplet.

    The reference's collect_data_series protocol
    (train/bullet_mpc_differential_drive.py:119-157): random start/goal per
    series, a plant the nominal model gets wrong (wheel-efficiency + coupling
    error), errors = x⁺ − F_nominal(x, u) — saved in the same
    states/controls/errors layout as saved_data/*_diff.npy (:334-336).
    """
    from .config import MPPIConfig, MPPIParams
    from .envs.closed_loop import collect_residual_dataset
    from .models import euler_step, unicycle
    from .paths.generators import line
    from .solvers.mppi import MPPISolver, MPPIState, make_tracking_costs

    dt = 0.05
    cfg = MPPIConfig(
        num_samples=args.samples,
        horizon=20,
        dim_x=3,
        dim_u=2,
        dt=dt,
        compute_optimal_traj=False,
    )
    nominal = lambda x, u: euler_step(unicycle, x, u, dt)
    solver = MPPISolver(cfg, nominal, *make_tracking_costs(cfg))

    def plant(x, u):
        u_eff = jnp.stack([0.85 * u[..., 0], 0.9 * u[..., 1] + 0.05 * u[..., 0]], -1)
        return euler_step(unicycle, x, u_eff, dt)

    def controller_factory(key):
        k1, k2 = jax.random.split(key)
        start = jax.random.uniform(k1, (2,), minval=-3.0, maxval=3.0)
        goal = jax.random.uniform(k2, (2,), minval=-8.0, maxval=8.0)
        params = MPPIParams(
            sigma=jnp.array([[0.1, 0.0], [0.0, 0.05]]),
            stage_weight=jnp.array([5.0, 5.0, 2.0]),
            terminal_weight=jnp.array([5.0, 5.0, 2.0]),
            u_min=jnp.array([-3.0, -3.14]),
            u_max=jnp.array([3.0, 3.14]),
            ref_path=line(start, goal, 100),
        )

        def controller(cs, x):
            u0, cs, _ = solver._step(params, cs, x, None)
            return u0, cs

        return controller, MPPIState.init(cfg, key)

    def x0_sampler(key):
        xy = jax.random.uniform(key, (2,), minval=-3.0, maxval=3.0)
        return jnp.concatenate([xy, jnp.zeros(1)])

    t0 = time.perf_counter()
    episode = collect_residual_dataset(
        controller_factory,
        plant,
        nominal,
        x0_sampler,
        jax.random.PRNGKey(args.seed),
        num_series=args.series,
        ticks_per_series=args.ticks,
    )
    jax.block_until_ready(episode)
    wall = time.perf_counter() - t0
    states = np.asarray(episode.states)
    controls = np.asarray(episode.controls)
    errors = np.asarray(episode.errors)
    np.savez(args.out, states=states, controls=controls, errors=errors)
    _emit(
        {
            "out": args.out,
            "series": args.series,
            "ticks_per_series": args.ticks,
            "rows": int(states.shape[0]),
            "mean_abs_residual": float(np.abs(errors).mean()),
            "wall_s": round(wall, 3),
        }
    )


# ---------------------------------------------------------------------------
# train


def cmd_realtime(args) -> None:
    """The BASELINE latency metric as a CLI command (the docstring of
    runtime/realtime_bench.py promised this entry point — round-4 review)."""
    from .runtime.realtime_bench import main as realtime_main

    argv = ["--hz", str(args.hz), "--ticks", str(args.ticks),
            "--k", str(args.k), "--t", str(args.t)]
    if args.json_out:
        argv += ["--json-out", args.json_out]
    realtime_main(argv)


def cmd_train(args: argparse.Namespace) -> None:
    from .models.learned import MLP, ResNet1D
    from .train.training import TrainConfig, train_residual_model

    data = np.load(args.data)
    states, controls, errors = data["states"], data["controls"], data["errors"]
    out_dim = errors.shape[-1]
    if args.model == "mlp":
        # reference deployment net: in→512×2(tanh)→out, zero-init head
        # (dnn/simple_mlp.py:5-24, train/train_diff_mlp.py)
        model = MLP(out_dim=out_dim, hidden=args.hidden, depth=args.depth)
    elif args.model in ("resnet18", "resnet50"):
        model = ResNet1D(out_dim=out_dim, variant=args.model[len("resnet") :])
    else:
        raise SystemExit(f"unknown --model {args.model!r}")

    t0 = time.perf_counter()
    tstate, hist = train_residual_model(
        model,
        jnp.asarray(states, jnp.float32),
        jnp.asarray(controls, jnp.float32),
        jnp.asarray(errors, jnp.float32),
        TrainConfig(
            num_epochs=args.epochs, batch_size=args.batch, seed=args.seed
        ),
    )
    wall = time.perf_counter() - t0
    ckpt = None
    if args.ckpt:
        import dataclasses

        from .train.checkpoint import save_checkpoint

        # full-resume tree: params + optimizer + in/out scalers (the shape
        # tests/test_learned.py::test_full_train_state_checkpoint_roundtrip
        # round-trips; orbax needs plain containers, not the TrainState class)
        save_checkpoint(
            args.ckpt,
            {
                "params": tstate.params,
                "opt_state": tstate.opt_state,
                "in_scaler": dataclasses.asdict(tstate.in_scaler),
                "out_scaler": dataclasses.asdict(tstate.out_scaler),
            },
        )
        ckpt = args.ckpt
    _emit(
        {
            "model": args.model,
            "rows": int(states.shape[0]),
            "epochs": args.epochs,
            "final_train_mse": float(hist["train_mse"][-1]),
            "final_val_mse": float(hist["val_mse"][-1]),
            "final_val_mae": float(hist["val_mae"][-1]),
            "checkpoint": ckpt,
            "wall_s": round(wall, 3),
        }
    )


# ---------------------------------------------------------------------------
# parser


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m dnn_mppi_mpc",
        description="MPPI / NMPC control engine CLI",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="backend, devices, available demos").set_defaults(
        fn=cmd_info
    )

    d = sub.add_parser("demo", help="run a closed-loop controller demo")
    d.add_argument("name", choices=sorted(_DEMOS))
    d.add_argument("--ticks", type=int, default=200)
    d.add_argument("--samples", type=int, default=1024, help="MPPI rollouts K")
    d.add_argument("--horizon", type=int, default=10)
    d.add_argument("--obstacles", action="store_true")
    d.add_argument(
        "--lookahead",
        action="store_true",
        help="diff-drive-mppi only: waypoint_carry='rollout' + persist='max' — "
        "the pure form of the reference's stateful waypoint lookup, recovering "
        "its closed-loop tracking speed (MIGRATION.md)",
    )
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--out", default=None, help="directory for trajectory/control plots")
    d.set_defaults(fn=cmd_demo)

    b = sub.add_parser("bench", help="chained-tick MPPI solves/s on a GPU")
    b.add_argument("--k", type=int, default=10240)
    b.add_argument("--t", type=int, default=50)
    b.set_defaults(fn=cmd_bench)

    c = sub.add_parser("collect", help="randomized-series residual dataset → .npz")
    c.add_argument("--series", type=int, default=8)
    c.add_argument("--ticks", type=int, default=200)
    c.add_argument("--samples", type=int, default=512, help="MPPI rollouts K")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--out", default="residual_dataset.npz")
    c.set_defaults(fn=cmd_collect)

    r = sub.add_parser(
        "realtime",
        help="one-process realtime pipeline measurement (pacer + solver + "
        "plant; runtime/realtime_bench.py)",
    )
    r.add_argument("--hz", type=float, default=50.0)
    r.add_argument("--ticks", type=int, default=10_000)
    r.add_argument("--k", type=int, default=10_240)
    r.add_argument("--t", type=int, default=50)
    r.add_argument("--json-out", type=str, default=None)
    r.set_defaults(fn=cmd_realtime)

    t = sub.add_parser("train", help="train a residual model from a collected .npz")
    t.add_argument("--data", required=True)
    t.add_argument("--model", default="mlp", choices=["mlp", "resnet18", "resnet50"])
    t.add_argument("--hidden", type=int, default=512)
    t.add_argument("--depth", type=int, default=2)
    t.add_argument("--epochs", type=int, default=50)
    t.add_argument("--batch", type=int, default=256)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--ckpt", default=None, help="orbax checkpoint directory")
    t.set_defaults(fn=cmd_train)
    return ap


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
