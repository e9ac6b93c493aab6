"""Real-time control loop: native pacing + jitted controller + telemetry.

The deployment shape of the reference (read robot state → solve → actuate →
sleep; simulation/bullet_differential_drive_dnn.py:419-467) with the pieces
that decide p99 latency made native: the pacer sleeps on absolute deadlines
(src/dmmrt.cpp) and telemetry is pushed into a lock-free ring instead of
print() (SURVEY §5.5). The controller itself is any jitted (state ↦ control)
callable — MPPI or NMPC.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Callable, Optional

import numpy as np

from .native import RatePacer, TelemetryRing


@contextlib.contextmanager
def realtime_scheduling(priority: int = 10):
    """Suppress the two dominant host-side tail sources inside a paced loop.

    1. Python GC: a collection pause lands inside a control slot at random;
       freeze the current heap and disable automatic collection (the loop
       allocates only per-tick temporaries, so the young generation stays
       tiny; everything is re-enabled + collected on exit).
    2. CFS scheduling: promote to SCHED_FIFO so a busy host cannot preempt
       the wake-up (needs CAP_SYS_NICE / root; silently skipped otherwise —
       the stats tell you which world you measured via ``rt_scheduling``).

    Yields a dict: {"rt_scheduling": bool} — whether FIFO was obtained.
    """
    info = {"rt_scheduling": False}
    old_policy = old_param = None
    try:
        old_policy = os.sched_getscheduler(0)
        old_param = os.sched_getparam(0)
        os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(priority))
        info["rt_scheduling"] = True
    except (OSError, PermissionError, AttributeError):
        pass
    gc_was_enabled = gc.isenabled()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield info
    finally:
        if gc_was_enabled:
            gc.enable()
        gc.unfreeze()
        gc.collect()
        if info["rt_scheduling"]:
            os.sched_setscheduler(0, old_policy, old_param)

TELEMETRY_DTYPE = np.dtype(
    [
        ("tick", np.int64),
        ("t_wall_ns", np.int64),
        ("solve_ns", np.int64),
        ("late_ns", np.int64),
        ("state", np.float32, (8,)),
        ("control", np.float32, (4,)),
    ]
)


class RealtimeLoop:
    """Paced closed loop around a jitted controller.

    ``read_state()`` and ``apply_control(u)`` are the hardware (or simulator)
    interface; ``controller(x) -> u`` must be a compiled function (first call
    is warmed up before pacing starts so compilation never eats a deadline).
    """

    def __init__(
        self,
        controller: Callable[[np.ndarray], np.ndarray],
        read_state: Callable[[], np.ndarray],
        apply_control: Callable[[np.ndarray], None],
        hz: float = 50.0,
        telemetry_capacity: int = 1 << 14,
        convert_arrays: bool = True,
        warmup_apply: bool = False,
        rt_scheduling: bool = True,
    ) -> None:
        self.controller = controller
        self.read_state = read_state
        self.apply_control = apply_control
        self.hz = hz
        self.telemetry_capacity = telemetry_capacity
        # convert_arrays=False keeps state/control as opaque handles (e.g.
        # jax.Arrays resident on the GPU — skipping a per-tick device→host
        # fetch that the loop itself never needs).
        # Telemetry then records timing only; the controller wrapper is
        # responsible for blocking until its result is actually ready so
        # solve_ns measures dispatch+compute+ready, not the async enqueue.
        self.convert_arrays = convert_arrays
        # warmup_apply=True also exercises apply_control once before pacing
        # begins, so a jitted plant/actuator bridge compiles outside the
        # deadline window. Leave False when apply_control actuates real
        # hardware — the warmup control WOULD be applied.
        self.warmup_apply = warmup_apply
        # rt_scheduling wraps the paced run in realtime_scheduling() —
        # PROCESS-GLOBAL side effects (gc.freeze+disable for the run's
        # duration, SCHED_FIFO promotion when permitted). Right for a
        # dedicated control process; set False when embedding the loop in a
        # larger application (a controller that allocates reference cycles
        # would otherwise accumulate uncollected garbage for the whole run,
        # and FIFO priority can starve sibling CFS threads on the core).
        self.rt_scheduling = rt_scheduling
        self.pacer: Optional[RatePacer] = None
        self._stop = None  # set by install_kill_switch (threading.Event)
        self.telemetry = TelemetryRing(telemetry_capacity, TELEMETRY_DTYPE)

    def install_kill_switch(self, signals: tuple = None) -> "threading.Event":
        """Operator kill-switch: arm signal handlers that request a graceful
        stop of ``run()`` at the next tick boundary.

        The reference's deployment loop uses a pynput keyboard listener for
        this (controllers/bullet_mpc_race_car_obstacle.py:23-29 — press a
        key, the loop flag flips, the car stops). A listener thread needs an
        X display; the headless-native equivalent is SIGINT/SIGTERM (Ctrl-C
        on an interactive run, the supervisor's stop on a deployed one).
        Returns the ``threading.Event`` so embedding code (or a real
        keyboard listener, where one exists) can also set it directly.
        Handlers are installed once; ``run()`` honors the event whether it
        came from a signal or a programmatic ``.set()``.
        """
        import signal as _signal
        import threading

        if self._stop is None:
            self._stop = threading.Event()
        for sig in signals or (_signal.SIGINT, _signal.SIGTERM):
            prev = _signal.getsignal(sig)

            def _handler(signum, frame, prev=prev):
                self._stop.set()
                # chain: a second Ctrl-C reaches the previous handler so a
                # wedged loop can still be interrupted the hard way
                _signal.signal(signum, prev)

            _signal.signal(sig, _handler)
        return self._stop

    def run(self, num_ticks: int) -> dict:
        """Run the loop; returns pacing statistics (overruns, worst lateness).

        Stops early (gracefully, at a tick boundary) when the kill-switch
        event from :meth:`install_kill_switch` is set; the returned stats
        carry ``stopped_by_operator`` and ``ticks_run``.
        """
        conv = np.asarray if self.convert_arrays else (lambda a: a)
        x = conv(self.read_state())
        u = conv(self.controller(x))  # warm-up / compile
        if self.warmup_apply:
            self.apply_control(u)  # compile the plant path too (opt-in)
        rec = np.zeros((), dtype=TELEMETRY_DTYPE)
        sched = (
            realtime_scheduling()
            if self.rt_scheduling
            else contextlib.nullcontext({"rt_scheduling": False})
        )
        ticks_run = 0
        with sched as rt:
            self.pacer = RatePacer(self.hz)
            for tick in range(num_ticks):
                if self._stop is not None and self._stop.is_set():
                    break
                late_ns = self.pacer.wait()
                x = conv(self.read_state())
                t0 = time.perf_counter_ns()
                u = conv(self.controller(x))
                solve_ns = time.perf_counter_ns() - t0
                self.apply_control(u)

                rec["tick"] = tick
                rec["t_wall_ns"] = time.perf_counter_ns()
                rec["solve_ns"] = solve_ns
                rec["late_ns"] = late_ns
                if self.convert_arrays:
                    # slice by total size, not last-axis length — a (4, 2)
                    # state has x.shape[-1]=2 but 8 elements (round-2 review
                    # finding)
                    nx = min(8, x.size)
                    nu = min(4, u.size)
                    rec["state"][:nx] = x.ravel()[:nx]
                    rec["control"][:nu] = u.ravel()[:nu]
                self.telemetry.push(rec)
                ticks_run += 1
            stats = dict(self.pacer.stats)
            stats.update(rt)
            stats["ticks_run"] = ticks_run
            stats["stopped_by_operator"] = bool(
                self._stop is not None and self._stop.is_set()
            )
        self.pacer.close()
        return stats

    def drain_telemetry(self) -> np.ndarray:
        """Pop everything currently buffered (up to the configured ring
        capacity — a hardcoded 1<<14 limit silently truncated larger rings,
        round-2 review finding)."""
        return self.telemetry.pop(self.telemetry_capacity)

    def close(self) -> None:
        """Release the native telemetry ring (and pacer, if still open)."""
        if self.pacer is not None:
            self.pacer.close()
            self.pacer = None
        self.telemetry.close()


__all__ = ["RealtimeLoop", "TELEMETRY_DTYPE"]
