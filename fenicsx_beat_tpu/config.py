"""Global precision / device configuration.

The reference runs all FEM in PETSc double precision.  The framework is
dtype-parametric: float64 when JAX x64 is enabled (CPU validation, matches
the reference's accuracy gates; the H100 also runs float64, at a fraction
of its float32 rate), float32 otherwise (the GPU production path, half the
bytes per node).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["default_dtype", "default_int"]


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_int():
    return jnp.int32
