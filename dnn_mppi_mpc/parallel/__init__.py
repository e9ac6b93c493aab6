from .distributed import (  # noqa: F401
    global_sample_mesh,
    host_scenario_mesh,
    initialize_distributed,
)
from .sharding import (  # noqa: F401
    make_batched_mppi_step,
    make_mesh,
    make_sharded_mppi_fleet,
    make_sharded_mppi_step,
    make_sharded_nmpc_fleet,
)
