"""fenicsx_beat_tpu — cardiac electrophysiology (monodomain and bidomain)
in JAX, run on NVIDIA GPUs.

A from-scratch JAX/XLA re-implementation of the capabilities of
finsberg/fenicsx-beat: precompiled sparse (stencil / ELL) operators,
jitted theta-rule stepping with on-device CG, fused ``lax.scan`` time loops,
a Pallas kernel for the ionic step and ``shard_map`` spatial sharding
replace the reference's UFL/FFCx/DOLFINx/PETSc/MPI stack.  (The package
name records the accelerator it was first written for.)

Public surface mirrors the reference package
(``src/beat/__init__.py:16-49``).
"""

def _tune_numpy_page_faults():
    """Disable numpy's MADV_HUGEPAGE on hosts where it is pathological.

    With ``transparent_hugepage/defrag = madvise`` the kernel runs
    *synchronous* compaction on every fault in a madvised VMA; on the
    virtualized single-vCPU hosts this framework targets for setup work
    that turns first-touch of large numpy buffers into a ~20 MB/s crawl
    (measured: 512 MB ``np.empty`` + fill = 29 s with numpy's default
    madvise, 0.3 s without — a 75x setup-time difference at the 442k-node
    Niederer resolution).  Set ``FBTPU_NUMPY_HUGEPAGE=1`` to keep numpy's
    default behavior.
    """
    import os

    if os.environ.get("FBTPU_NUMPY_HUGEPAGE") == "1":
        return
    try:
        try:
            from numpy._core import multiarray as _ma
        except ImportError:  # numpy < 2
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
        import logging

        logging.getLogger(__name__).debug(
            "disabled numpy MADV_HUGEPAGE (set FBTPU_NUMPY_HUGEPAGE=1 to keep "
            "numpy's default)"
        )
    except Exception:
        pass


_tune_numpy_page_faults()


from . import (  # noqa: E402
    base_model,
    conductivities,
    config,
    fem,
    mesh,
    stimulation,
    telemetry,
    units,
)
from .base_model import BaseModel, Results, Status
from .monodomain_model import MonodomainModel
from .stimulation import Stimulus
from .telemetry import BaseMonitor, NullMonitor, PerformanceMonitor

__version__ = "0.1.0"
__author__ = "fenicsx-beat-tpu developers"
__program_name__ = "fenicsx-beat-tpu"

from . import (  # noqa: E402
    adjoint,
    bidomain,
    ecg,
    fused,
    geometry,
    io,
    models,
    monodomain_model,
    monodomain_solver,
    odefile,
    odesolver,
    single_cell,
    utils,
)
from .bidomain import BidomainSolver
from .ecg import ECGRecovery
from .fused import FusedMonodomainSolver
from .monodomain_solver import MonodomainSplittingSolver

__all__ = [
    "monodomain_model",
    "odefile",
    "odesolver",
    "base_model",
    "MonodomainModel",
    "monodomain_solver",
    "MonodomainSplittingSolver",
    "utils",
    "conductivities",
    "stimulation",
    "geometry",
    "single_cell",
    "ecg",
    "Stimulus",
    "ECGRecovery",
    "telemetry",
    "BaseMonitor",
    "NullMonitor",
    "PerformanceMonitor",
    "fem",
    "mesh",
    "units",
    "fused",
    "FusedMonodomainSolver",
    "io",
    "models",
    "adjoint",
    "bidomain",
    "BidomainSolver",
]
