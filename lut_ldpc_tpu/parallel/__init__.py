"""Multi-device scale-out: SPMD data parallelism over a jax device mesh.

The reference scales Monte-Carlo BER out by running one statically linked
binary per seed per host and merging result files offline
(the reference's README.md:54, scripts/aggregate_results.m).  The
equivalent here is one SPMD program: frames are sharded over a ('dp',)
mesh, every device simulates its own global batch with a counter-based RNG
key, and the per-batch error counters are gathered in-program.
"""

from .mesh import (
    dp_mesh,
    dp_mesh_2d,
    make_dp_step,
    make_dp_step_2d,
    multihost_init,
)

__all__ = ["dp_mesh", "dp_mesh_2d", "make_dp_step", "make_dp_step_2d",
           "multihost_init"]
