"""Concurrency stress + ThreadSanitizer harness for the C++ host runtime.

SURVEY §5.2: the reference ships no sanitizers or race detection; this is the
subsystem the new framework adds for its lock-free structures (SPSC telemetry
ring, seqlock state channel, rate pacer — runtime/src/dmmrt.cpp). The
invariant checks live in runtime/src/stress_dmmrt.cpp; this driver builds and
runs it twice: -O2 for high-iteration semantic stress, -fsanitize=thread for
data-race detection (the seqlock's buffer copies are word-wise relaxed
atomics precisely so TSAN can vouch for them).
"""

import os
import shutil
import subprocess

import pytest

_SRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "dnn_mppi_mpc",
    "runtime",
    "src",
)
_SOURCES = [
    os.path.join(_SRC_DIR, "dmmrt.cpp"),
    os.path.join(_SRC_DIR, "stress_dmmrt.cpp"),
]

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _build_and_run(tmp_path, extra_flags, args):
    exe = str(tmp_path / "stress")
    subprocess.run(
        ["g++", "-std=c++17", "-pthread", *extra_flags, "-o", exe, *_SOURCES],
        check=True,
        capture_output=True,
    )
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=1")
    proc = subprocess.run(
        [exe, *map(str, args)], capture_output=True, text=True, timeout=300, env=env
    )
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout
    return proc


@needs_gxx
def test_stress_optimized(tmp_path):
    """High-iteration run: FIFO/exactly-once/payload integrity on the ring,
    torn-snapshot detection on the seqlock, pacer accounting."""
    _build_and_run(tmp_path, ["-O2"], [500000, 300000, 2])


@needs_gxx
@pytest.mark.slow
def test_stress_tsan(tmp_path):
    """Same invariants under ThreadSanitizer; TSAN reports exit nonzero via
    halt_on_error so any data race fails the test."""
    try:
        proc = _build_and_run(
            tmp_path, ["-O1", "-g", "-fsanitize=thread"], [60000, 30000, 1]
        )
    except subprocess.CalledProcessError as e:  # pragma: no cover
        pytest.skip(f"TSAN unavailable: {e.stderr[:200]}")
    except AssertionError as e:  # pragma: no cover
        # TSAN can compile but fail to START on some kernels ("FATAL:
        # ThreadSanitizer: unexpected memory mapping" under incompatible
        # ASLR) — that's environment unavailability, not a data race
        if "ThreadSanitizer:" in str(e) and "data race" not in str(e):
            pytest.skip(f"TSAN cannot run here: {str(e)[:200]}")
        raise
    assert "WARNING: ThreadSanitizer" not in proc.stderr
