"""Multi-host entry points for the sharded solver.

The reference's distribution entry is the MPI communicator passed into
DOLFINx mesh construction (reference ``geometry.py:112-139``, launched by
``mpirun``).  The JAX equivalent is ``jax.distributed`` process
initialization plus a ``jax.sharding.Mesh`` over the global device list:
the same :class:`~fenicsx_beat_tpu.parallel.solver.ShardedMonodomainSolver`
program then spans hosts — XLA routes halo ``ppermute``s over the
intra-host links (NVLink between the GPUs of one host) and the network
across hosts, with no code change.

Single-host multi-device needs none of this: build the mesh directly from
``jax.devices()`` (see ``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

import logging

import numpy as np

__all__ = ["initialize_distributed", "make_device_mesh", "is_coordinator"]

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-process jax (idempotent).

    With no arguments, jax auto-detects the cluster environment (SLURM,
    Open MPI); elsewhere pass ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``.  Call once per process before any other
    jax use — the reference's ``mpirun -n N`` moment.
    """
    import jax

    try:  # idempotence probe; the state module moved across jax versions
        from jax._src.distributed import global_state as _gs

        if getattr(_gs, "client", None) is not None:
            logger.debug("jax.distributed already initialized")
            return
    except Exception:
        pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as exc:
        # Stay single-process when no explicit cluster was requested, the
        # way a reference script runs identically with and without mpirun.
        # ValueError: no cluster environment to auto-detect.  RuntimeError:
        # the XLA backend already exists (any prior jax call in the script)
        # — too late to go multi-process, but single-process still works.
        if kwargs:
            raise
        logger.info(
            "single-process fallback (%s: %s)", type(exc).__name__, exc
        )
        return
    logger.info(
        "jax.distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def make_device_mesh(n_devices: int | None = None, axis: str = "x"):
    """1-D ``jax.sharding.Mesh`` over the (global) device list.

    ``n_devices=None`` uses every device.  The mesh axis is the node
    partition axis of :class:`ShardedMonodomainSolver` — the analogue of
    ``MPI.COMM_WORLD``'s rank dimension.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n = len(devices) if n_devices is None else int(n_devices)
    if n > len(devices):
        raise ValueError(
            f"requested {n} devices, only {len(devices)} available "
            f"({devices[0].platform})"
        )
    return Mesh(np.array(devices[:n]), (axis,))


def is_coordinator() -> bool:
    """True on process 0 — the reference's ``comm.rank == 0`` IO gate."""
    import jax

    return jax.process_index() == 0
