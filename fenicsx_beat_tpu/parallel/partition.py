"""Host-side 1-D node partitioning with planar halos.

Replaces DOLFINx/MPI mesh partitioning + ghost index maps (reference
``geometry.py:112-139``; ghost layout visible at reference
``tests/test_odesolver.py:63``).  The structured slab generators order
nodes lexicographically with x slowest (``fenicsx_beat_tpu.mesh``), so a
contiguous equal-size block partition along x gives each device a slab
whose matrix rows only reference columns within a bounded halo of its
block — the halo is exchanged with the two ICI neighbors via
``lax.ppermute``.

``partition_ell`` turns a global ELL matrix into per-device local blocks
with columns remapped into the device's extended index space
``[0, n_loc + 2*halo)``:

    [ left-halo (H) | owned block (n_loc) | right-halo (H) ]
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..ops.sparse import ELLMatrix

__all__ = [
    "Partition1D",
    "partition_nodes",
    "partition_ell",
    "partition_stencil",
    "partition_quadrature",
]


@dataclass(frozen=True)
class Partition1D:
    n_global: int  # true number of dofs
    n_devices: int
    n_local: int  # padded equal block size (n_pad = n_devices * n_local)
    halo: int  # uniform halo width

    @property
    def n_pad(self) -> int:
        return self.n_devices * self.n_local


def partition_nodes(n: int, n_devices: int) -> tuple[int, int]:
    """Equal padded block size."""
    n_local = -(-n // n_devices)
    return n_local, n_devices * n_local


def pad_global(x: np.ndarray, part: Partition1D, fill: float = 0.0) -> np.ndarray:
    """Pad the trailing (node) axis of a global array to n_pad."""
    pad = part.n_pad - x.shape[-1]
    if pad == 0:
        return x
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    return np.pad(x, widths, constant_values=fill)


def partition_ell(
    A: ELLMatrix, n_devices: int
) -> tuple[Partition1D, jnp.ndarray, jnp.ndarray, tuple | None]:
    """Split a global ELL matrix into stacked per-device local blocks.

    Returns ``(partition, cols_local [ndev, n_local, W], vals [ndev,
    n_local, W], tail)`` where ``tail`` is ``None`` or per-device COO-tail
    arrays ``(rows [ndev, nt] local-row int32, cols [ndev, nt]
    extended-local-col int32, vals [ndev, nt])`` covering the hybrid
    matrix's spilled high-degree entries (e.g. the welded LV apex), padded
    per device with inert zero-value slots.  Raises if any row reaches
    beyond its neighbors' blocks (the 1-D partition assumption is violated
    — reorder nodes first, e.g. with RCM).
    """
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    W = cols.shape[1]
    n_local, n_pad = partition_nodes(n, n_devices)

    # pad rows: identity row (diag 1) so padded dofs stay inert under CG
    pad = n_pad - n
    if pad:
        pad_cols = np.tile(np.arange(n, n_pad, dtype=cols.dtype)[:, None], (1, W))
        pad_vals = np.zeros((pad, W), dtype=vals.dtype)
        pad_vals[:, 0] = 1.0
        cols = np.concatenate([cols, pad_cols], axis=0)
        vals = np.concatenate([vals, pad_vals], axis=0)

    if A.has_tail:
        t_rows = np.asarray(A.tail_rows, dtype=np.int64)
        t_cols = np.asarray(A.tail_cols, dtype=np.int64)
        t_vals = np.asarray(A.tail_vals)
    else:
        t_rows = t_cols = np.zeros(0, dtype=np.int64)
        t_vals = np.zeros(0, dtype=vals.dtype)

    # required halo: max reach of any entry (main or tail) outside its
    # row's block
    row_block = np.repeat(np.arange(n_pad) // n_local, W).reshape(n_pad, W)
    block_start = row_block * n_local
    reach_left = np.maximum(0, block_start - cols)
    reach_right = np.maximum(0, cols - (block_start + n_local - 1))
    halo = int(max(reach_left.max(), reach_right.max()))
    if t_rows.size:
        t_start = (t_rows // n_local) * n_local
        halo = max(
            halo,
            int(np.maximum(0, t_start - t_cols).max()),
            int(np.maximum(0, t_cols - (t_start + n_local - 1)).max()),
        )
    if halo > n_local:
        raise ValueError(
            f"halo {halo} exceeds local block {n_local}: too many devices for "
            "this mesh (or node ordering is not partition-friendly)"
        )

    part = Partition1D(n_global=n, n_devices=n_devices, n_local=n_local, halo=halo)

    # remap columns to the extended local index space
    cols_local = cols - block_start + halo
    cols3 = cols_local.reshape(n_devices, n_local, W).astype(np.int32)
    vals3 = vals.reshape(n_devices, n_local, W)

    tail3 = None
    if t_rows.size:
        dev = t_rows // n_local
        counts = np.bincount(dev, minlength=n_devices)
        nt = int(counts.max())
        # inert pad slots: val 0, col 0 (any in-bounds extended index)
        tr3 = np.zeros((n_devices, nt), dtype=np.int32)
        tc3 = np.zeros((n_devices, nt), dtype=np.int32)
        tv3 = np.zeros((n_devices, nt), dtype=t_vals.dtype)
        for d in range(n_devices):
            sel = np.nonzero(dev == d)[0]
            k = sel.size
            tr3[d, :k] = (t_rows[sel] - d * n_local).astype(np.int32)
            tc3[d, :k] = (t_cols[sel] - d * n_local + halo).astype(np.int32)
            tv3[d, :k] = t_vals[sel]
        tail3 = (tr3, tc3, tv3)

    # numpy-backed: the solver device_puts these once with their final
    # shardings
    return part, cols3, vals3, tail3


def partition_stencil(
    A: "StencilMatrix", n_devices: int, diag_pad: float = 0.0
) -> tuple[Partition1D, jnp.ndarray]:
    """Split a global stencil matrix into per-device local value blocks.

    Returns (partition, vals [ndev, n_local, K]); the halo equals the
    largest |offset| so every shifted read lands inside the extended local
    vector ``[left-halo | owned | right-halo]``.  ``diag_pad`` is written
    at offset 0 for the padded rows (1.0 for the mass keeps the combined
    theta-system diagonal positive, so padded dofs stay inert under
    Jacobi-CG).
    """
    from ..ops.sparse import StencilMatrix  # noqa: F401 (typing)

    n = A.shape[0]
    vals = np.asarray(A.vals)
    K = vals.shape[1]
    n_local, n_pad = partition_nodes(n, n_devices)
    halo = max(abs(int(d)) for d in A.offsets)
    if halo > n_local:
        raise ValueError(
            f"stencil halo {halo} exceeds local block {n_local}: too many "
            "devices for this mesh"
        )
    pad = n_pad - n
    if pad:
        pad_vals = np.zeros((pad, K), dtype=vals.dtype)
        if diag_pad:
            k0 = A.offsets.index(0)
            pad_vals[:, k0] = diag_pad
        vals = np.concatenate([vals, pad_vals], axis=0)
    part = Partition1D(n_global=n, n_devices=n_devices, n_local=n_local, halo=halo)
    # numpy-backed, see partition_ell
    return part, vals.reshape(n_devices, n_local, K)


def partition_quadrature(quad, part: Partition1D, iperm: np.ndarray | None = None):
    """Per-device quadrature tables for load assembly under the 1-D node
    partition (non-separable stimuli — the reference assembles these with
    DOLFINx over each MPI rank's cells).

    Each device receives the (padded) subset of elements that touch any of
    its owned rows, with dof slots masked by ownership so boundary elements
    shared by two devices contribute each entry exactly once.  Returns
    ``(X [ndev, ne, nq, g], W [ndev, ne, nq], N [nq, nd],
    dofs_local [ndev, ne, nd] int32, own [ndev, ne, nd])``; pad elements
    replicate a real element with zero weight.
    """
    X = np.asarray(quad.X)
    W = np.asarray(quad.W)
    N = np.asarray(quad.N)
    dofs = np.asarray(quad.dofs, dtype=np.int64)
    if iperm is not None:
        dofs = np.asarray(iperm, dtype=np.int64)[dofs]
    nd_, nl = part.n_devices, part.n_local
    dev_of = dofs // nl  # [ne, ndpc]

    selections = [np.nonzero((dev_of == d).any(axis=1))[0] for d in range(nd_)]
    ne_max = max(max((s.size for s in selections), default=0), 1)

    Xs = np.zeros((nd_, ne_max) + X.shape[1:], dtype=X.dtype)
    Ws = np.zeros((nd_, ne_max) + W.shape[1:], dtype=W.dtype)
    Ds = np.zeros((nd_, ne_max, dofs.shape[1]), dtype=np.int32)
    Os = np.zeros((nd_, ne_max, dofs.shape[1]), dtype=W.dtype)
    for d, sel in enumerate(selections):
        k = sel.size
        # pad elements replicate element 0 (weight 0) so the traced
        # expression is evaluated at real coordinates
        Xs[d] = X[0]
        if k == 0:
            continue
        Xs[d, :k] = X[sel]
        Ws[d, :k] = W[sel]
        own = dev_of[sel] == d
        Ds[d, :k] = np.where(own, dofs[sel] - d * nl, 0).astype(np.int32)
        Os[d, :k] = own
    # numpy-backed, see partition_ell
    return (Xs, Ws, N, Ds, Os)
