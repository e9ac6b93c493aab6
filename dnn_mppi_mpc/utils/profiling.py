"""Profiling and roofline accounting (first-class, per SURVEY §5.1).

The reference's only instrumentation is wall-clock deltas around solver calls
(controllers/mpc_mlp_differential_drive.py:173-189). Here:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-compatible trace directory.
* :class:`Timer` — blocking wall-clock timer with p50/p90/p99 percentiles,
  the Hz/ms reporting of the reference's harnesses done properly.
* :func:`mppi_roofline` — analytic FLOP/byte model of the rollout kernel to
  judge its distance from the device-memory roofline of a given card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace('/tmp/tb'): run()`` → profile viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Latency collector with percentile reporting.

    >>> t = Timer()
    >>> for _ in range(100):
    ...     with t:
    ...         jax.block_until_ready(step(...))
    >>> t.summary()  # {'p50_ms': ..., 'p99_ms': ..., 'hz': ...}
    """

    def __init__(self) -> None:
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.samples.append(time.perf_counter() - self._t0)

    def percentile(self, q: float) -> float:
        s = sorted(self.samples)
        return s[min(len(s) - 1, int(len(s) * q))]

    def summary(self) -> dict:
        if not self.samples:
            return {}
        p50 = self.percentile(0.5)
        return {
            "n": len(self.samples),
            "p50_ms": p50 * 1e3,
            "p90_ms": self.percentile(0.9) * 1e3,
            "p99_ms": self.percentile(0.99) * 1e3,
            "mean_ms": sum(self.samples) / len(self.samples) * 1e3,
            "hz": 1.0 / p50,
        }


def time_fn(fn: Callable, *args, iters: int = 50, warmup: int = 2) -> dict:
    """Benchmark a jitted function with full blocking; returns Timer summary."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t = Timer()
    for _ in range(iters):
        with t:
            jax.block_until_ready(fn(*args))
    return t.summary()


# Published peaks by JAX ``device_kind`` (NVIDIA H100 SXM data sheet). Only
# the device-memory rate is listed: the f32 rate outside the tensor cores is
# not yet checked on the card, so no compute bound is computed from it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def mppi_roofline(
    K: int,
    T: int,
    W: int,
    device_kind: str,
    dim_u: int = 2,
    n_obs: int = 0,
) -> dict:
    """Analytic cost model of the rollout kernel (ops/pallas/rollout.py).

    Per (sample, step): ~10 dynamics/clamp flops + ~10·W window-search flops +
    ~8·n_obs obstacle flops. Device-memory traffic: ε in (K·T·dim_u·4 B) + S
    out (K·4 B). Returns the least time the memory roofline allows; a device
    missing from :data:`PEAKS` is an error, not a default.
    """
    if device_kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; known: {sorted(PEAKS)}"
        )
    peak = PEAKS[device_kind]
    flops = K * T * (10 + 10 * W + 8 * n_obs)
    bytes_moved = K * T * dim_u * 4 + K * 4
    return {
        "flops": flops,
        "bytes": bytes_moved,
        "t_memory_us": bytes_moved / peak["hbm_bytes_per_s"] * 1e6,
        "arithmetic_intensity": flops / bytes_moved,
        "device_kind": device_kind,
    }


__all__ = ["trace", "Timer", "time_fn", "mppi_roofline", "PEAKS"]
