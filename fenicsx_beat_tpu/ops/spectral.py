"""DCT-based spectral preconditioning for constant-stencil operators.

The bidomain extracellular block is pure stiffness — unlike the
monodomain theta system it is NOT mass-dominated, and Jacobi-CG
iterations grow like O(1/h) (measured 190/step at a 48² sheet,
docs/DESIGN.md §6b).  On the structured grids this framework's stencil
path already detects, the interior stiffness row is one constant stencil,
and the cosine (DCT-II) basis nearly diagonalizes it under Neumann
boundaries: preconditioning with the exact inverse of that
constant-stencil operator is spectrally equivalent, collapsing the
iteration count to O(1) in mesh size.

Applying it is two separable DCT sweeps per CG iteration — small dense
per-axis products, with no gather at all.

Eigenvalue model: for symmetric displacement pairs ±(d₁,…,d_D) a
constant-coefficient stencil acts on the DCT-II mode (k₁,…,k_D) as
``c · Π_a cos(π k_a d_a / N_a)`` (the antisymmetric sine cross-terms of
diagonal pairs fall outside the cosine basis and are dropped — this is a
preconditioner, spectral equivalence is enough).

The model requires genuinely constant coefficients and unambiguous
offset decoding, so :func:`stencil_dct_eigenvalues` declines (returns
``None`` → callers fall back to Jacobi) when interior rows differ
(heterogeneous conductivity), when any axis has fewer than 4 nodes
(offset decoding is ambiguous and there is no interior row), or when an
offset does not decode to a within-reach grid displacement.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "grid_shape",
    "stencil_dct_eigenvalues",
    "dct_solve",
    "stencil_dct_solver",
]


def grid_shape(mesh) -> tuple[int, ...] | None:
    """Node dimensions of a lexicographically ordered tensor grid, or
    ``None``.  The framework's structured meshes (create_rectangle /
    create_box / the slab geometries) enumerate nodes as
    ``ix*(Ny*Nz) + iy*Nz + iz`` over a uniform product grid."""
    coords = mesh.coords
    n, gdim = coords.shape
    axes = [np.unique(coords[:, a]) for a in range(gdim)]
    if int(np.prod([len(u) for u in axes])) != n:
        return None
    dims = tuple(len(u) for u in axes)
    # verify lexicographic order (last axis fastest) and uniform spacing
    grids = np.meshgrid(*axes, indexing="ij")
    expect = np.stack([g.ravel() for g in grids], axis=1)
    if not np.allclose(expect, coords, atol=1e-12):
        return None
    for u in axes:
        if len(u) > 2 and not np.allclose(np.diff(u), u[1] - u[0], rtol=1e-8):
            return None
    return dims


def _strides(dims) -> np.ndarray:
    s = np.ones(len(dims), dtype=np.int64)
    for a in range(len(dims) - 2, -1, -1):
        s[a] = s[a + 1] * dims[a + 1]
    return s


def _decode_offsets(offsets, dims):
    """Flat stencil offsets -> per-axis displacements with |d_a| <= 1 (the
    P1 simplex reach), or ``None``.  Requires every axis >= 4 nodes so the
    decode is unambiguous (a 2- or 3-node axis lets a wraparound multi-jump
    masquerade as a neighbor displacement)."""
    if any(N < 4 for N in dims):
        return None
    strides = _strides(dims)
    out = []
    for o in offsets:
        hit = None
        for d in np.ndindex(*([3] * len(dims))):
            disp = tuple(x - 1 for x in d)  # each in {-1, 0, 1}
            if int(np.dot(disp, strides)) == int(o):
                hit = disp
                break
        if hit is None:
            return None
        out.append(hit)
    return out


def stencil_dct_eigenvalues(stencil, mesh, dtype=None):
    """``(lam [dims], dims)`` for the DCT-II eigenvalue model of
    ``stencil``'s constant interior row, or ``None`` when the mesh is not
    a tensor grid, the coefficients are not constant across interior rows
    (heterogeneous conductivity), or the offsets do not decode.

    ``lam`` is a host numpy array so callers can thread it through a jit
    operand pytree instead of baking it into the compiled program."""
    dims = grid_shape(mesh)
    if dims is None:
        return None
    disps = _decode_offsets(stencil.offsets, dims)
    if disps is None:
        return None
    vals = np.asarray(stencil.vals)
    strides = _strides(dims)
    center_idx = [d // 2 for d in dims]
    center = int(np.dot(center_idx, strides))
    c = vals[center]
    # constancy guard: the model is built from ONE row; decline when other
    # interior rows disagree (e.g. per-cell scar conductivities) — a
    # mis-scaled global preconditioner is worse than Jacobi
    probes = []
    for a in range(len(dims)):
        for d in (-1, 1):
            idx = list(center_idx)
            idx[a] += d
            if 0 < idx[a] < dims[a] - 1:
                probes.append(int(np.dot(idx, strides)))
    for p in probes:
        if not np.allclose(vals[p], c, rtol=1e-8, atol=1e-12 * np.abs(c).max()):
            return None

    lam = np.zeros(dims)
    for coef, disp in zip(c, disps):
        term = np.ones(dims)
        for a, (d_a, N_a) in enumerate(zip(disp, dims)):
            k = np.arange(N_a)
            cos = np.cos(np.pi * k * abs(d_a) / N_a)
            shape = [1] * len(dims)
            shape[a] = N_a
            term = term * cos.reshape(shape)
        lam += coef * term
    scale = np.abs(lam).max()
    pos = lam[np.abs(lam) > 1e-12 * scale]
    if pos.size == 0:
        return None
    floor = float(np.abs(pos).min())
    lam = np.where(np.abs(lam) < 1e-12 * scale, np.mean(np.abs(pos)), lam)
    lam = np.maximum(lam, 0.25 * floor)  # SPD guard for the dropped cross-terms
    npdt = np.dtype(jnp.dtype(dtype).name) if dtype is not None else vals.dtype
    return lam.astype(npdt), dims


def _dct_matrix(N: int, dtype) -> jnp.ndarray:
    """Orthonormal DCT-II matrix (scipy ``norm='ortho'`` convention):
    ``C[k, n] = s_k cos(pi (n + 1/2) k / N)``.  Built from static shapes
    at trace time, so XLA constant-folds it into the executable."""
    n = jnp.arange(N, dtype=jnp.float64 if dtype == jnp.float64 else jnp.float32)
    k = n[:, None]
    C = jnp.cos(jnp.pi * (n + 0.5) * k / N)
    s = jnp.where(k == 0, jnp.sqrt(1.0 / N), jnp.sqrt(2.0 / N))
    return (s * C).astype(dtype)


def dct_solve(r: jnp.ndarray, lam: jnp.ndarray, dims: tuple[int, ...]) -> jnp.ndarray:
    """Apply the DCT-diagonal inverse: ``z ≈ stencil⁻¹ r`` for the model
    operator whose eigenvalues are ``lam`` (from
    :func:`stencil_dct_eigenvalues`).

    Implemented as separable per-axis MATMULS, not FFTs: at solver grid
    sizes (e.g. 201 x 71 x 31 at dx=0.1) the transform is a few small
    dense products, while ``jax.scipy.fft.dctn`` on awkward
    (non-power-of-2) axis lengths lowers to padded FFTs."""
    # HIGHEST matmul precision: on the GPU an f32 matmul may otherwise run
    # in TF32 (10-bit mantissa), which perturbs the forward and inverse
    # transforms differently and breaks the preconditioner's symmetry —
    # a non-symmetric preconditioner stalls CG
    hi = jax.lax.Precision.HIGHEST
    x = r.reshape(dims)
    for a, N in enumerate(dims):
        C = _dct_matrix(N, x.dtype)
        x = jnp.moveaxis(jnp.tensordot(C, x, axes=((1,), (a,)), precision=hi), 0, a)
    x = x / lam.reshape(dims)
    for a, N in enumerate(dims):
        C = _dct_matrix(N, x.dtype)
        x = jnp.moveaxis(jnp.tensordot(C.T, x, axes=((1,), (a,)), precision=hi), 0, a)
    return x.reshape(r.shape)


def stencil_dct_solver(stencil, mesh, dtype=None) -> Callable | None:
    """Convenience closure form of the solver (eigenvalues captured —
    prefer :func:`stencil_dct_eigenvalues` + :func:`dct_solve` with the
    eigenvalues threaded as a jit operand when calling from jitted code)."""
    out = stencil_dct_eigenvalues(stencil, mesh, dtype=dtype)
    if out is None:
        return None
    lam, dims = out
    lam_j = jnp.asarray(lam)

    def apply(r):
        return dct_solve(r, lam_j, dims)

    return apply
