"""dnn_mppi_mpc — a JAX MPPI / trajectory-optimization framework.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the reference
repo SokhengDin/DNN-MPPI-MPC (sampling-based MPPI controllers, acados/CasADi
NMPC, learned-dynamics hybrid control, training and simulation loops), with
NVIDIA GPU kernels on the hot path:

* ``solvers.mppi``  — one batched MPPI engine (vmap/scan + a Pallas GPU rollout)
  replacing the eight numpy/torch/cupy controller variants.
* ``solvers.sqp``   — jitted SQP-RTI NMPC with a Riccati interior-point QP,
  replacing acados codegen + HPIPM (c_generated_code/).
* ``models``        — batched analytic dynamics + Flax learned dynamics,
  replacing l4casadi/TorchScript bridges (_l4c_generated/).
* ``parallel``      — sample/scenario sharding over a device mesh via shard_map.
* ``paths``, ``train``, ``envs``, ``utils`` — path generation, training and
  data-collection pipelines, plants, profiling.
"""

from . import config  # noqa: F401

__version__ = "0.1.0"
