"""Characterize the native RatePacer's deadline jitter on this host.

The realtime deployment loop (runtime/loop.py, mirroring the reference's
PyBullet actuation loop at simulation/bullet_differential_drive_dnn.py:419-467)
is paced by the C++ absolute-deadline pacer (runtime/src/dmmrt.cpp). The GPU
solve is a small fraction of the 20 ms period (docs/PERF.md), so the
end-to-end 50 Hz p99 budget rests on the HOST half: how late past each
deadline does ``clock_nanosleep`` wake?

Run: ``python examples/pacer_characterization.py [--seconds 4]``
Prints one JSON line per rate with lateness percentiles (µs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from dnn_mppi_mpc.runtime.native import RatePacer  # noqa: E402


def characterize(hz: float, seconds: float) -> dict:
    pacer = RatePacer(hz=hz)
    n = max(10, int(seconds * hz))
    late_ns = np.empty(n, dtype=np.int64)
    for i in range(n):
        late_ns[i] = pacer.wait()
    stats = pacer.stats
    pacer.close()
    us = late_ns / 1e3
    return {
        "metric": f"pacer_lateness_us_{int(hz)}hz",
        "ticks": int(n),
        "p50": round(float(np.percentile(us, 50)), 1),
        "p90": round(float(np.percentile(us, 90)), 1),
        "p99": round(float(np.percentile(us, 99)), 1),
        "worst": round(float(us.max()), 1),
        "overruns": int(stats["overruns"]),
        "period_us": round(1e6 / hz, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    for hz in (50.0, 250.0):
        print(json.dumps(characterize(hz, args.seconds)))


if __name__ == "__main__":
    main()
