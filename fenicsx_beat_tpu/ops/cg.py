"""Jitted preconditioned conjugate-gradient solver.

Replaces PETSc KSP (reference ``src/beat/base_model.py:140-157,236``).  The
reference defaults to CG + hypre BoomerAMG or direct LU/MUMPS; the
theta-scheme system ``C_m*Mass + theta*dt*K`` is mass-dominated (dt is
small), so Jacobi-preconditioned CG converges in a handful of iterations.
The loop is a ``lax.while_loop`` with a data-dependent trip count; on the
GPU, XLA copies its predicate to the host once per iteration (a 4-byte
device->host copy per CG iteration in a profiler trace).

The ``dot`` argument abstracts the inner product so the same code runs
sharded under ``shard_map`` (dots become ``lax.psum`` — the analogue of
the per-iteration MPI allreduce inside PETSc KSP).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CGInfo(NamedTuple):
    iterations: jnp.ndarray  # int32
    residual_norm: jnp.ndarray  # float
    converged: jnp.ndarray  # bool


def cg(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    precond_diag: jnp.ndarray | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 1000,
    dot: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] | None = None,
    precond: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> tuple[jnp.ndarray, CGInfo]:
    """Solve A x = b for SPD A with preconditioned CG.

    ``precond`` (a general SPD preconditioner application ``z = P^{-1} r``,
    e.g. the DCT solver of :mod:`..ops.spectral`) takes precedence over
    the Jacobi ``precond_diag``."""
    if dot is None:
        dot = lambda a, c: jnp.vdot(a, c)  # noqa: E731
    if x0 is None:
        x0 = jnp.zeros_like(b)
    minv = None if precond_diag is None else 1.0 / precond_diag

    def apply_prec(r):
        if precond is not None:
            return precond(r)
        return r if minv is None else r * minv

    r0 = b - matvec(x0)
    z0 = apply_prec(r0)
    bnorm = jnp.sqrt(dot(b, b))
    tol = jnp.maximum(rtol * bnorm, atol)

    def cond(state):
        x, r, z, p, rz, k = state
        return jnp.logical_and(k < maxiter, jnp.sqrt(dot(r, r)) > tol)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    init = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0, dtype=jnp.int32))
    x, r, z, p, rz, k = jax.lax.while_loop(cond, body, init)
    rnorm = jnp.sqrt(dot(r, r))
    return x, CGInfo(iterations=k, residual_norm=rnorm, converged=rnorm <= tol)

