"""Chained-tick timing — the throughput protocol of the benchmarks.

A workload's control tick (solver step + plant step) is chained ``n`` times
on the device inside one jitted ``lax.scan``; the host times the whole chain
up to ``block_until_ready`` and divides by ``n``. One dispatch per chain, so
the per-tick figure is device time plus a dispatch cost amortized over
``n`` ticks. The spread of the per-chain figures gives p50/p99.

This module is the single implementation used by ``bench.py``, the suite
(utils/benchsuite.py), the CLI and the examples.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List


@dataclass(frozen=True)
class ChainTiming:
    """Result of :func:`chain_timing`. All times in seconds per tick."""

    best: float
    p50: float
    p99: float
    n: int  # ticks per chain
    per_tick: List[float]  # sorted, one entry per timed chain

    @property
    def ticks_per_s(self) -> float:
        return 1.0 / self.p50


def chain_timing(make_runner: Callable[[int], Callable[[], object]], n: int, reps: int) -> ChainTiming:
    """Time ``reps`` runs of an ``n``-tick chain after one compile + warm-up
    run. ``make_runner(n)`` returns a zero-argument callable that runs the
    chain and returns its output, which is waited on here."""
    import jax

    if n < 1 or reps < 1:
        raise ValueError(f"need n >= 1 and reps >= 1, got n={n} reps={reps}")
    run = make_runner(n)
    jax.block_until_ready(run())
    per_tick = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        per_tick.append((time.perf_counter() - t0) / n)
    per_tick.sort()

    def pct(q: float) -> float:
        return per_tick[min(len(per_tick) - 1, int(q * len(per_tick)))]

    return ChainTiming(best=per_tick[0], p50=pct(0.50), p99=pct(0.99), n=n, per_tick=per_tick)


def scan_chain_runner(body, params, st0, x0, n):
    """The standard timed runner: n ticks of ``body`` chained on the device.

    ``body(params, state, x) -> ((state, x), y)`` is the per-tick step.
    ``params`` rides through jit as an argument, not as a captured constant,
    so every workload compiles the same program a deployment would.
    """
    import jax

    @jax.jit
    def chain(params, state, x):
        (state, x), ys = jax.lax.scan(
            lambda carry, _: body(params, *carry), (state, x), None, length=n
        )
        return x, ys

    return lambda: chain(params, st0, x0)


__all__ = ["ChainTiming", "chain_timing", "scan_chain_runner"]
