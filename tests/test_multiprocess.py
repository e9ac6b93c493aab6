"""True multi-process (multi-controller) validation on CPU.

Launches examples/scaling_run.py as TWO OS processes with 4 virtual CPU
devices each: jax.distributed.initialize over a localhost coordinator, Gloo
cross-process collectives, and the sample-sharded MPPI step running on an
8-device global mesh that spans both controllers — the code path a
multi-host GPU job uses (SURVEY §5.8), one level stronger than the
in-process virtual mesh the rest of the suite exercises.

Regression context (round 2): this path was broken three separate ways —
cluster auto-detection hanging in containers (fixed by
cluster_detection_method="deactivate" in parallel/distributed.py), a
module-level jnp.array in ops/costs.py initializing the backend at import so
jax.distributed.initialize refused, and the scale sweep building meshes from
process-0 devices only.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_scaling_job(n_proc, devices_per_proc, extra_args=(), timeout=420):
    """Launch scaling_run.py as n_proc OS processes; return proc-0's summary."""
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    args = [
        sys.executable,
        os.path.join(REPO, "examples", "scaling_run.py"),
        "--coordinator", f"localhost:{port}",
        "--num-processes", str(n_proc),
        "--k-per-device", "32",
        "--horizon", "5",
        "--chain", "4",
        "--reps", "1",
        *extra_args,
    ]
    workers = [
        subprocess.Popen(
            args + ["--process-id", str(i)],
            env=env, cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        for i in range(1, n_proc)
    ]
    try:
        p0 = subprocess.run(
            args + ["--process-id", "0"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout,
        )
    finally:
        # if p0 died early, workers block forever at the coordinator barrier —
        # kill the exact children we spawned so the failure surfaces instead
        # of a TimeoutExpired from wait() and orphaned spinners
        for w in workers:
            try:
                w.wait(timeout=60)
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait(timeout=30)
    assert p0.returncode == 0, p0.stderr[-2000:]
    json_lines = [
        json.loads(l) for l in p0.stdout.splitlines() if l.startswith("{")
    ]
    return json_lines[-1]


@pytest.mark.slow
def test_two_process_sharded_mppi(tmp_path):
    summary = _run_scaling_job(2, 4)
    assert summary["metric"] == "mppi_weak_scaling_efficiency"
    assert summary["n_hosts"] == 2
    # global mesh spans both controllers: 2 procs x 4 devices
    assert summary["scales"][-1]["devices"] == 8
    assert summary["scales"][-1]["solves_per_s"] > 0
    # every sweep point is a multiple of process_count (mesh must span both)
    assert all(s["devices"] % 2 == 0 for s in summary["scales"])


@pytest.mark.slow
def test_four_process_sharded_mppi_scaling_artifact(tmp_path):
    """4 controllers x 2 devices — the multi-host rehearsal one level beyond
    the two-process job (round-4 verdict #7): an 8-device global mesh spans
    FOUR jax.distributed processes, per-tick collective latency is timed
    separately, and the summary carries every field a multi-host GPU run
    records, so such a run diffs 1:1 against this rehearsal."""
    out = tmp_path / "scaling.json"
    summary = _run_scaling_job(4, 2, extra_args=["--out", str(out)], timeout=600)
    assert summary["metric"] == "mppi_weak_scaling_efficiency"
    assert summary["n_hosts"] == 4
    assert [s["devices"] for s in summary["scales"]] == [4, 8]
    for s in summary["scales"]:
        assert s["solves_per_s"] > 0
        # collective-only timing path executed (at this toy scale on Gloo
        # only presence is asserted — magnitudes belong to a GPU run)
        assert isinstance(s["collective_per_tick_ms"], float)
    assert set(summary["efficiency"]) == {"4", "8"}
    # --out wrote the same summary (the artifact-generation path)
    disk = json.loads(out.read_text())
    assert disk["scales"] == summary["scales"]


@pytest.mark.slow
def test_package_import_is_backend_clean():
    """Importing the whole package must NOT initialize an XLA backend:
    jax.distributed.initialize refuses to run after any backend init, so an
    import side effect (e.g. a module-level jnp.array — ops/costs.py had one)
    breaks every multi-controller user. Runs in a subprocess so this test is
    independent of suite import order."""
    code = """
import jax
import dnn_mppi_mpc
import dnn_mppi_mpc.solvers, dnn_mppi_mpc.solvers.cem
import dnn_mppi_mpc.presets, dnn_mppi_mpc.paths
import dnn_mppi_mpc.envs.closed_loop, dnn_mppi_mpc.envs.sensors
import dnn_mppi_mpc.train.training, dnn_mppi_mpc.train.rl
import dnn_mppi_mpc.parallel.sharding, dnn_mppi_mpc.parallel.distributed
import dnn_mppi_mpc.ops.filters, dnn_mppi_mpc.ops.costs
import dnn_mppi_mpc.testing.oracle
jax.distributed.initialize("localhost:%d", num_processes=1, process_id=0,
                           cluster_detection_method="deactivate")
print("CLEAN")
""" % _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=180,
    )
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr[-2000:]
