"""Multi-host initialization and mesh construction (NVLink between the cards
of a host, the network between hosts — SURVEY §5.8).

The reference has no distributed code; this is the multi-GPU scaling path:
``jax.distributed`` initialization, then a global Mesh whose sample axis
spans every card. The per-tick cross-device traffic of the sharded MPPI
(parallel/sharding.py) is three tiny reductions, so sample sharding stays
within a host's all-to-all NVLink; scenario batching shards the fleet across
hosts, which exchange data only at episode boundaries.

On a single process this degrades gracefully (no-op initialize, local mesh),
which is also the CI path (virtual CPU mesh).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed when running multi-process.

    With no arguments it initializes only when ``COORDINATOR_ADDRESS`` is
    set (JAX's cluster auto-detection); silently no-ops when already
    initialized or when single-process.
    """
    try:
        if coordinator_address is not None:
            # explicit args ⇒ skip cluster auto-detection: in containerized
            # environments the detection probes hang instead of failing fast
            # (verified: with "deactivate" a two-process CPU job initializes
            # and runs Gloo collectives; without it both processes hang)
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                cluster_detection_method="deactivate",
            )
        elif os.environ.get("COORDINATOR_ADDRESS"):
            jax.distributed.initialize()
    except RuntimeError:
        pass  # already initialized


def global_sample_mesh(axis_name: str = "k") -> Mesh:
    """1-D mesh over every device in the job (all hosts)."""
    devices = np.asarray(jax.devices())
    return Mesh(devices, (axis_name,))


def host_scenario_mesh(
    sample_axis: str = "k", batch_axis: str = "batch"
) -> Mesh:
    """2-D mesh: scenario batch across hosts, samples within a host.

    Put the high-frequency reductions (the per-tick pmin/psum of the MPPI
    softmax) on the *inner* axis so they stay on the host's NVLink; the
    scenario axis only exchanges data at episode boundaries.
    """
    n_hosts = jax.process_count()
    n_local = jax.local_device_count()
    devices = np.asarray(jax.devices()).reshape(n_hosts, n_local)
    return Mesh(devices, (batch_axis, sample_axis))


__all__ = ["initialize_distributed", "global_sample_mesh", "host_scenario_mesh"]
