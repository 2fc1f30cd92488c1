"""Multi-device spatial sharding: partitioning, halo exchange, sharded solver.

JAX replacement for the reference's MPI domain decomposition
(DOLFINx mesh partitioning + PETSc VecGhost scatters + per-iteration KSP
allreduces — see SURVEY.md §5.8 and reference ``base_model.py:203-206,
241-242``).  Node arrays are sharded over a 1-D ``jax.sharding.Mesh``;
SpMV halos ride ``lax.ppermute`` (neighbor exchanges), CG dot products are
``lax.psum``.  The ODE stage is embarrassingly parallel — zero
communication, exactly like the reference's.
"""

from . import partition  # noqa: F401
from .distributed import (  # noqa: F401
    initialize_distributed,
    is_coordinator,
    make_device_mesh,
)
from .bidomain import ShardedBidomainSolver  # noqa: F401
from .solver import ShardedMonodomainSolver  # noqa: F401
