"""CLI smoke + behavior tests: ``python -m dnn_mppi_mpc <command>``.

The CLI is the framework's replacement for the reference's hard-coded
``if __name__ == "__main__"`` constants (SURVEY §1, §5.6 — no config/flag
system anywhere). Every command must emit ONE machine-readable JSON line as
its last stdout line; these tests parse it and assert on the payload.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, tmp_path):
    # In-process (NOT a subprocess): each subprocess paid ~5 s of fresh jax
    # import before any work — 9 CLI tests made this file one of the most
    # expensive in the suite (verdict r3 #9). cli.main(argv) is a plain
    # function; the conftest already pins the CPU mesh for this process.
    import contextlib
    import io

    from dnn_mppi_mpc.cli import main as cli_main

    # force (not setdefault): an interactive MPLBACKEND exported in the
    # developer env must not leak a GUI backend into the test process
    os.environ["MPLBACKEND"] = "Agg"
    buf = io.StringIO()
    cwd = os.getcwd()
    try:
        os.chdir(REPO)
        with contextlib.redirect_stdout(buf):
            cli_main(args)
    except SystemExit as e:
        assert not e.code, f"cli {args} exited with {e.code}:\n{buf.getvalue()}"
    finally:
        os.chdir(cwd)
    out = buf.getvalue().strip()
    assert out, f"cli {args} produced no output"
    last = out.splitlines()[-1]
    return json.loads(last)


def test_cli_info(tmp_path):
    out = _run_cli(["info"], tmp_path)
    assert out["backend"] == "cpu"
    assert "diff-drive-mppi" in out["demos"]
    assert out["device_count"] >= 1


@pytest.mark.parametrize(
    "name,extra",
    [
        ("diff-drive-mppi", ["--samples", "128", "--obstacles"]),
        ("goal-seeking-mppi", ["--samples", "128", "--horizon", "25"]),
        ("racecar-mppi", ["--samples", "128", "--ticks", "10"]),
        ("diff-drive-nmpc", ["--ticks", "30"]),
        # the heavier NMPC demos stay in the slow set (~10 s subprocess
        # compile each; presets covered in-process by tests/test_nmpc.py)
        pytest.param("racecar-nmpc", ["--ticks", "10"], marks=pytest.mark.slow),
        pytest.param(
            "four-wheel-nmpc", ["--ticks", "30"], marks=pytest.mark.slow
        ),
    ],
)
def test_cli_demo_runs_finite(name, extra, tmp_path):
    out = _run_cli(["demo", name, "--ticks", "20"] + extra, tmp_path)
    assert out["finite"], out
    assert out["ticks_per_s"] > 0


def test_cli_demo_goal_seeking_reaches_goal(tmp_path):
    out = _run_cli(
        ["demo", "goal-seeking-mppi", "--ticks", "120", "--samples", "256",
         "--horizon", "25"],
        tmp_path,
    )
    assert out["goal_distance_final_m"] < 1.0, out


def test_cli_demo_writes_artifacts(tmp_path):
    out = _run_cli(
        ["demo", "diff-drive-mppi", "--ticks", "10", "--samples", "64",
         "--out", str(tmp_path)],
        tmp_path,
    )
    assert len(out["artifacts"]) == 2
    for p in out["artifacts"]:
        assert os.path.exists(p), p


def test_cli_collect_then_train_roundtrip(tmp_path):
    data = str(tmp_path / "data.npz")
    ckpt = str(tmp_path / "ckpt")
    out = _run_cli(
        ["collect", "--series", "2", "--ticks", "25", "--samples", "96",
         "--out", data],
        tmp_path,
    )
    assert out["rows"] == 2 * 25
    assert out["mean_abs_residual"] > 0  # plant ≠ nominal → nonzero residuals
    out = _run_cli(
        ["train", "--data", data, "--model", "mlp", "--hidden", "32",
         "--depth", "1", "--epochs", "4", "--ckpt", ckpt],
        tmp_path,
    )
    assert out["final_val_mse"] > 0 and out["final_val_mse"] < 100
    assert os.path.isdir(ckpt)


def test_cli_bench_smoke(tmp_path):
    """bench is a GPU measurement: on the CPU it refuses to measure."""
    with pytest.raises(RuntimeError, match="no GPU"):
        _run_cli(["bench", "--k", "128", "--t", "8"], tmp_path)
