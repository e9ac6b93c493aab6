"""Utils tests: Timer percentiles, metrics writer, roofline model, episode CSV."""

import json
import os
import time

import numpy as np

from dnn_mppi_mpc.utils.logging import MetricsWriter, save_episode_csv
from dnn_mppi_mpc.utils.profiling import Timer, mppi_roofline, time_fn


def test_timer_percentiles():
    t = Timer()
    for d in [0.001, 0.002, 0.003, 0.004, 0.01]:
        with t:
            time.sleep(d)
    s = t.summary()
    assert s["n"] == 5
    assert s["p50_ms"] >= 2.5
    assert s["p99_ms"] >= s["p50_ms"]
    assert s["hz"] > 0


def test_time_fn_blocks():
    import jax.numpy as jnp

    f = lambda x: jnp.sum(x * x)
    s = time_fn(f, jnp.ones(1000), iters=5, warmup=1)
    assert s["n"] == 5 and s["p50_ms"] > 0


def test_roofline_model_sane():
    r = mppi_roofline(K=10240, T=50, W=20, device_kind="NVIDIA H100 80GB HBM3")
    assert r["flops"] == 10240 * 50 * (10 + 10 * 20)
    bytes_moved = 10240 * 50 * 2 * 4 + 10240 * 4
    assert r["bytes"] == bytes_moved
    # H100 HBM3: 3.35 TB/s (data sheet)
    assert abs(r["t_memory_us"] - bytes_moved / 3.35e12 * 1e6) < 1e-9
    # the rollout does far more arithmetic than it moves bytes
    assert r["arithmetic_intensity"] > 10


def test_roofline_unknown_device_raises():
    import pytest

    with pytest.raises(ValueError, match="no published peaks"):
        mppi_roofline(K=1024, T=10, W=20, device_kind="cpu")


def test_metrics_writer_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    w = MetricsWriter(path)
    w.write(0, loss=1.5, note="start")
    w.write(1, loss=np.float32(0.7))
    w.close()
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["loss"] == 1.5 and lines[0]["note"] == "start"
    assert abs(lines[1]["loss"] - 0.7) < 1e-6
    assert all("ts" in l for l in lines)


def test_episode_csv(tmp_path):
    path = str(tmp_path / "ep.csv")
    states = np.random.default_rng(0).normal(size=(10, 3))
    controls = np.random.default_rng(1).normal(size=(10, 2))
    save_episode_csv(path, states, controls)
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    assert data.shape == (10, 5)
    np.testing.assert_allclose(data[:, :3], states)
