#!/usr/bin/env python
"""Parallel test-suite runner: the whole not-slow suite in ~1/P the wall clock.

The suite is ~325 tests across 45 files; single-process it costs ~10-11 min
on this class of host, dominated by Python tracing + x64 CPU execution of a
handful of heavy solver tests (not XLA compiles — those hit the persistent
per-host cache, ``utils/platform.py::enable_compilation_cache``). This script
shards test FILES over P worker subprocesses (greedy longest-processing-time
using measured per-file weights) and aggregates results. ``pytest-xdist`` is
also available in the image (``pytest -n 4 -m "not slow" tests/``) — this
runner exists because file-level sharding with per-file weights balances this
particular suite better than xdist's per-test round-robin with its
many-minute solver files, and its shard logs keep heavy-file output separate.

    python runtests.py            # P = min(8, cpu_count), not-slow suite
    python runtests.py -p 4
    python runtests.py --slow     # include the slow marker (long gates)
    python runtests.py -k sqp -x  # unknown flags forward to every worker

Exit code 0 iff every worker passed (pytest exit 5 = "no tests collected in
this shard" counts as pass, e.g. an all-slow file in the not-slow run) AND at
least one shard actually collected tests — if every shard exits 5 (e.g. a
``-k`` filter typo matched nothing) the run fails with exit 3.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time

# Measured per-file wall-clock (seconds, not-slow set, --durations run on this
# host class, 2026-08). Files absent here default to 8 s; exact values only
# matter for balance, not correctness.
WEIGHTS = {
    "test_resnet_dynamics.py": 60,
    "test_qp.py": 55,
    "test_diff_nmpc.py": 50,
    "test_riccati_qp.py": 50,
    "test_nmpc.py": 45,
    "test_sharding.py": 40,
    "test_examples_smoke.py": 35,
    "test_runtime.py": 25,
    "test_dynamics.py": 25,
    "test_reference_crosscheck_racecar.py": 20,
    "test_learned.py": 20,
    "test_waypoint_carry.py": 20,
    "test_cli.py": 15,
    "test_mppi_learned.py": 15,
    "test_mppi_parity.py": 15,
    "test_generic_tick.py": 25,
    "test_chip_smoke.py": 60,
    "test_sqp_vs_scipy.py": 12,
}


def partition(files: list[str], p: int) -> list[list[str]]:
    """Greedy LPT: heaviest file to the currently lightest bin."""
    bins: list[list[str]] = [[] for _ in range(p)]
    loads = [0.0] * p
    for f in sorted(files, key=lambda f: -WEIGHTS.get(os.path.basename(f), 8)):
        i = loads.index(min(loads))
        bins[i].append(f)
        loads[i] += WEIGHTS.get(os.path.basename(f), 8)
    return [b for b in bins if b]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-p", "--procs", type=int,
                    default=min(8, os.cpu_count() or 4))
    ap.add_argument("--slow", action="store_true",
                    help="include tests marked slow")
    # No positional bucket: a positional nargs="*" steals the VALUE of an
    # unknown flag (`-k expr` -> unknown=['-k'], positional=['expr'],
    # order lost). parse_known_args with no positional keeps unknown args
    # in order, and they all forward to every pytest worker.
    args, pytest_args = ap.parse_known_args()
    args.pytest_args = pytest_args

    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(root, "tests", "test_*.py")))
    if not files:
        print("no test files found", file=sys.stderr)
        return 2

    shards = partition(files, args.procs)
    base = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider"]
    if not args.slow:
        base += ["-m", "not slow"]
    base += list(args.pytest_args)

    t0 = time.time()
    procs = []
    logs = []
    for i, shard in enumerate(shards):
        log = open(os.path.join(root, f".pytest_shard_{i}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            base + shard, stdout=log, stderr=subprocess.STDOUT, cwd=root,
        ))
    codes = [pr.wait() for pr in procs]
    dt = time.time() - t0

    ok = True
    collected_any = False
    for i, (code, log) in enumerate(zip(codes, logs)):
        log.close()
        with open(log.name) as f:
            tail = [l.rstrip() for l in f.readlines()[-3:]]
        summary = tail[-1] if tail else "(no output)"
        status = "ok" if code in (0, 5) else f"FAIL rc={code}"
        if code == 0:
            collected_any = True
        print(f"shard {i}: {status:10s} {summary}")
        if code not in (0, 5):
            ok = False
            print(f"  see {log.name}")
    print(f"total wall: {dt:.0f}s over {len(shards)} workers")
    if ok and not collected_any:
        print("ERROR: every shard exited 5 (no tests collected) — check any "
              "-k/-m filter you forwarded", file=sys.stderr)
        return 3
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
