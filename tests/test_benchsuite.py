"""bench.py --suite: every benchmark row in one command, on the GPU only.

The suite measures on the card and refuses the CPU (a CPU number is not a
measurement of this program). These tests run each row's builder at a small
size on the CPU, so every workload constructs, compiles and runs its chained
tick end to end here, and check the refusal.
"""

from __future__ import annotations

import jax
import pytest

from dnn_mppi_mpc.utils import benchsuite


def test_suite_rows_registry_complete():
    assert set(benchsuite.ROWS) == set(benchsuite.BUILDERS)
    assert set(benchsuite.KERNEL_ROWS) <= set(benchsuite.ROWS)


def test_suite_unknown_row_rejected():
    with pytest.raises(ValueError, match="unknown suite rows"):
        benchsuite.run_suite(rows=("no_such_row",), reps=1)


def test_suite_light_rows_run_on_cpu():
    """The measurement itself refuses to run without a GPU."""
    with pytest.raises(RuntimeError, match="no GPU"):
        benchsuite.run_suite(rows=("mppi_fleet", "goal_seeking"), reps=1)


@pytest.mark.parametrize("row", benchsuite.ROWS)
def test_suite_row_builds_and_runs(row):
    w = benchsuite.BUILDERS[row](True, True)
    assert w.name == row and w.n > 0 and w.solves_per_tick >= 1
    out = jax.block_until_ready(w.make_runner(2)())
    leaves = jax.tree.leaves(out)
    assert leaves and all(bool(jax.numpy.all(jax.numpy.isfinite(a))) for a in leaves)
    # this CPU takes the plain XLA paths
    assert w.meta.get("path", "xla_scan") == "xla_scan"
    assert w.meta.get("qp_backend", "xla") == "xla"
