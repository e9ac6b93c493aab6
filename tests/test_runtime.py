"""Native runtime tests: build, pacer timing, ring integrity (threaded), seqlock."""

import threading
import time

import numpy as np
import pytest

from dnn_mppi_mpc.runtime.native import (
    RatePacer,
    StateChannel,
    TelemetryRing,
    build_library,
)


def test_library_builds():
    path = build_library()
    assert path.endswith("libdmmrt.so")


def test_pacer_rate_and_stats():
    pacer = RatePacer(hz=200.0)  # 5 ms period
    t0 = time.perf_counter()
    n = 40
    for _ in range(n):
        pacer.wait()
    elapsed = time.perf_counter() - t0
    # 40 ticks at 5 ms ≈ 200 ms; generous CI bounds
    assert 0.15 < elapsed < 0.6, elapsed
    stats = pacer.stats
    assert stats["ticks"] == n
    pacer.close()


def test_ring_push_pop_order():
    dtype = np.dtype([("a", np.int64), ("b", np.float32)])
    ring = TelemetryRing(64, dtype)
    for i in range(10):
        rec = np.zeros((), dtype=dtype)
        rec["a"] = i
        rec["b"] = i * 0.5
        assert ring.push(rec)
    out = ring.pop(100)
    assert out.shape[0] == 10
    np.testing.assert_array_equal(out["a"], np.arange(10))
    ring.close()


def test_ring_drops_when_full_never_blocks():
    dtype = np.dtype([("a", np.int64)])
    ring = TelemetryRing(8, dtype)
    rec = np.zeros((), dtype=dtype)
    oks = [ring.push(rec) for _ in range(12)]
    assert sum(oks) == 8
    assert ring.dropped == 4
    ring.close()


def test_ring_threaded_spsc_integrity():
    """Producer thread pushes a sequence; consumer must read it in order,
    gap-free. The producer retries rejected pushes (ring full), so no record
    is lost; `dropped` counts the rejections (push never blocks, dmmrt.cpp
    ring_push) and must match the producer's own rejection count exactly —
    under scheduler lag it is legitimately nonzero."""
    dtype = np.dtype([("seq", np.int64)])
    ring = TelemetryRing(1024, dtype)
    N = 20000
    received = []
    rejections = 0

    def producer():
        nonlocal rejections
        rec = np.zeros((), dtype=dtype)
        i = 0
        while i < N:
            rec["seq"] = i
            if ring.push(rec):
                i += 1
            else:
                rejections += 1  # ring full — spin until consumer drains

    def consumer():
        while len(received) < N:
            out = ring.pop(256)
            if out.shape[0]:
                received.extend(out["seq"].tolist())

    # daemon: if an assertion below fires while a thread is still spinning
    # (producer retries a full ring forever), a non-daemon thread would hang
    # interpreter shutdown and mask the failure (round-2 review finding)
    tp = threading.Thread(target=producer, daemon=True)
    tc = threading.Thread(target=consumer, daemon=True)
    tp.start(), tc.start()
    tp.join(timeout=30), tc.join(timeout=30)
    assert len(received) == N
    assert received == list(range(N))
    assert ring.dropped == rejections
    ring.close()


def test_state_channel_snapshot_consistency():
    dtype = np.dtype([("x", np.float64, (3,)), ("stamp", np.int64)])
    chan = StateChannel(dtype)
    assert chan.read() is None  # nothing written yet

    v = np.zeros((), dtype=dtype)
    v["x"] = [1.0, 2.0, 3.0]
    v["stamp"] = 42
    chan.write(v)
    got = chan.read()
    np.testing.assert_array_equal(got["x"], [1.0, 2.0, 3.0])
    assert got["stamp"] == 42

    stop = threading.Event()
    torn = []

    def writer():
        w = np.zeros((), dtype=dtype)
        i = 0
        while not stop.is_set():
            w["x"] = [i, i, i]  # all three must always match
            w["stamp"] = i
            chan.write(w)
            i += 1

    def reader():
        while not stop.is_set():
            g = chan.read()
            if g is not None and not (g["x"][0] == g["x"][1] == g["x"][2]):
                torn.append(g)

    tw = threading.Thread(target=writer)
    trs = [threading.Thread(target=reader) for _ in range(2)]
    tw.start()
    [t.start() for t in trs]
    time.sleep(0.5)
    stop.set()
    tw.join(), [t.join() for t in trs]
    assert not torn, f"torn reads detected: {torn[:3]}"
    chan.close()


def test_realtime_loop_with_fake_plant():
    from dnn_mppi_mpc.runtime.loop import RealtimeLoop

    state = {"x": np.zeros(3)}

    def read_state():
        return state["x"]

    def apply_control(u):
        state["x"] = state["x"] + 0.01 * np.array([u[0], u[1], 0.0])

    def controller(x):
        return np.array([1.0, -1.0])

    loop = RealtimeLoop(controller, read_state, apply_control, hz=500.0)
    stats = loop.run(50)
    assert stats["ticks"] == 50
    tel = loop.drain_telemetry()
    assert tel.shape[0] == 50
    assert np.all(np.diff(tel["tick"]) == 1)
    assert state["x"][0] > 0.4  # controls applied


def test_pacer_jitter_p99_within_50hz_period():
    """Host-side half of the realtime 50 Hz claim (verdict #8): deadline
    lateness p99 must stay within the period on this host. Loose bound — the
    shared CI host shows ~80 µs p50 with multi-ms tail spikes
    (examples/pacer_characterization.py prints the full percentiles)."""
    from dnn_mppi_mpc.runtime.loop import realtime_scheduling

    # RT scheduling (when permitted) + GC freeze stabilizes the measurement
    # against concurrent load — without it this test flaked when another
    # suite hogged the host (lateness is a property of the scheduler, not
    # the pacer)
    with realtime_scheduling():
        pacer = RatePacer(hz=50.0)
        n = 100
        late = np.array([pacer.wait() for _ in range(n)], dtype=np.int64)
        pacer.close()
    p99 = np.percentile(late, 99)
    assert p99 < 20e6, f"p99 lateness {p99/1e6:.2f} ms exceeds the 20 ms period"
    assert np.median(late) < 2e6, f"median lateness {np.median(late)/1e6:.2f} ms"


def test_realtime_e2e_cpu_smoke():
    """The realtime measurement is a GPU measurement: on the CPU it refuses
    to run instead of reporting CPU latencies as the system's."""
    from dnn_mppi_mpc.runtime.realtime_bench import run_realtime_e2e

    with pytest.raises(RuntimeError, match="no GPU"):
        run_realtime_e2e(hz=200.0, ticks=40, K=256, T=10)


def test_kill_switch_stops_loop_gracefully():
    """Operator kill-switch (the reference's pynput interrupt,
    bullet_mpc_race_car_obstacle.py:23-29, done headless-native): SIGINT
    mid-run stops the paced loop at a tick boundary, stats record the
    early stop, and telemetry holds exactly the executed ticks."""
    import os
    import signal
    import threading

    from dnn_mppi_mpc.runtime.loop import RealtimeLoop

    ticked = []

    def controller(x):
        ticked.append(1)
        return np.zeros(2)

    loop = RealtimeLoop(
        controller, lambda: np.zeros(3), lambda u: None,
        hz=200.0, rt_scheduling=False,
    )
    stop = loop.install_kill_switch()
    killer = threading.Timer(0.15, lambda: os.kill(os.getpid(), signal.SIGINT))
    killer.start()
    try:
        stats = loop.run(100_000)  # would take ~8 min without the switch
    finally:
        killer.cancel()
        loop.close()
    assert stats["stopped_by_operator"] is True
    assert 0 < stats["ticks_run"] < 100_000
    assert stop.is_set()
    # a second run with the event pre-set exits immediately
    loop2 = RealtimeLoop(
        controller, lambda: np.zeros(3), lambda u: None,
        hz=200.0, rt_scheduling=False,
    )
    loop2._stop = stop
    try:
        stats2 = loop2.run(50)
    finally:
        loop2.close()
    assert stats2["ticks_run"] == 0 and stats2["stopped_by_operator"]
