"""Sparse operators in ELL (padded row) and stencil format.

Replaces PETSc sparse matrices used by the reference (assembled at
``src/beat/base_model.py:123,193,202``).  ELL with row-sorted, padded
column indices maps cleanly onto XLA: an SpMV is one static-shape
gather plus a row-wise multiply-reduce, which XLA fuses into a single
bandwidth-bound kernel.  Matrices are assembled once on host (numpy) and
live on device as a pytree of jnp arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclass
class ELLMatrix:
    """Padded sparse matrix: row i has entries (cols[i, k], vals[i, k)).

    Padding entries point at column ``i`` itself with value 0 so the gather
    stays in-bounds without masking.

    Hybrid tail: a few high-degree rows (e.g. the welded apex of the LV
    ellipsoid, degree ~2*n_theta) would otherwise force the padded width
    onto every row.  Entries beyond the capped width spill into a COO tail
    (``tail_rows/cols/vals``) applied with a scatter-add — the main ELL
    stays narrow.
    """

    cols: jnp.ndarray  # [n_rows, width] int32
    vals: jnp.ndarray  # [n_rows, width] float
    shape: tuple[int, int]
    tail_rows: jnp.ndarray | None = None  # [nt] int32
    tail_cols: jnp.ndarray | None = None  # [nt] int32
    tail_vals: jnp.ndarray | None = None  # [nt] float

    def tree_flatten(self):
        return (self.cols, self.vals, self.tail_rows, self.tail_cols, self.tail_vals), (
            self.shape,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        cols, vals, tr, tc, tv = children
        return cls(cols=cols, vals=vals, shape=aux[0], tail_rows=tr, tail_cols=tc, tail_vals=tv)

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def has_tail(self) -> bool:
        return self.tail_rows is not None and self.tail_rows.shape[0] > 0

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        return ell_spmv(self, x)

    def diagonal(self) -> jnp.ndarray:
        n = self.shape[0]
        if isinstance(self.vals, np.ndarray):
            # host path: keeps the numpy-backed setup pipeline off-device
            rows = np.arange(n, dtype=self.cols.dtype)[:, None]
            d = np.sum(np.where(self.cols == rows, self.vals, 0.0), axis=1)
            if self.has_tail:
                on_diag = self.tail_rows == self.tail_cols
                np.add.at(d, self.tail_rows, np.where(on_diag, self.tail_vals, 0.0))
            return d
        rows = jnp.arange(n, dtype=self.cols.dtype)[:, None]
        mask = self.cols == rows
        d = jnp.sum(jnp.where(mask, self.vals, 0.0), axis=1)
        if self.has_tail:
            on_diag = self.tail_rows == self.tail_cols
            d = d.at[self.tail_rows].add(jnp.where(on_diag, self.tail_vals, 0.0))
        return d

    def scale_values(self, alpha) -> "ELLMatrix":
        return self.combine(alpha, None, 0.0)

    def with_values(self, vals: jnp.ndarray, tail_vals: jnp.ndarray | None = None) -> "ELLMatrix":
        return ELLMatrix(
            cols=self.cols,
            vals=vals,
            shape=self.shape,
            tail_rows=self.tail_rows,
            tail_cols=self.tail_cols,
            tail_vals=self.tail_vals if tail_vals is None else tail_vals,
        )

    def combine(self, ca, other: "ELLMatrix | None", cb) -> "ELLMatrix":
        """``ca*self + cb*other`` for matrices sharing the sparsity pattern
        (mass/stiffness pairs); value-level arithmetic, no re-gather."""
        vals = ca * self.vals + (cb * other.vals if other is not None else 0.0)
        tail = None
        if self.has_tail:
            tail = ca * self.tail_vals + (
                cb * other.tail_vals if other is not None else 0.0
            )
        return self.with_values(vals, tail)

    def to_device(self) -> "ELLMatrix":
        """One-shot host->device push of all arrays.

        Assembly stays numpy-backed end to end; solvers call this
        exactly once after all host-side processing."""
        put = jax.device_put
        return ELLMatrix(
            cols=put(jnp.asarray(self.cols)),
            vals=put(jnp.asarray(self.vals)),
            shape=self.shape,
            tail_rows=None if self.tail_rows is None else put(jnp.asarray(self.tail_rows)),
            tail_cols=None if self.tail_cols is None else put(jnp.asarray(self.tail_cols)),
            tail_vals=None if self.tail_vals is None else put(jnp.asarray(self.tail_vals)),
        )


def ell_spmv(A: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A @ x via gather + row reduce. x: [n_cols] or [n_cols, k]."""
    if x.ndim == 1:
        y = jnp.sum(A.vals * x[A.cols], axis=1)
        if A.has_tail:
            y = y.at[A.tail_rows].add(A.tail_vals * x[A.tail_cols])
        return y
    # batched columns
    # HIGHEST: an f32 contraction may otherwise run in TF32 on the GPU
    y = jnp.einsum(
        "rw,rwk->rk", A.vals, x[A.cols], precision=jax.lax.Precision.HIGHEST
    )
    if A.has_tail:
        y = y.at[A.tail_rows].add(A.tail_vals[:, None] * x[A.tail_cols])
    return y


def coo_to_ell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    dtype=None,
) -> ELLMatrix:
    """Assemble duplicate-summed COO triplets into a padded ELL matrix.

    Matrices assembled from the same (rows, cols) pattern (mass/stiffness
    pairs) produce identical layouts, so they can be combined value-wise on
    device (:meth:`ELLMatrix.combine`).
    """
    n_rows = shape[0]
    # native C++ path (fenicsx_beat_tpu/native/beatkit.cpp) when built
    from ..native import available as _native_ok, coo_to_ell_arrays

    if _native_ok():
        ell_cols, ell_vals, _, counts = coo_to_ell_arrays(rows, cols, vals, shape)
        return _build_ell(ell_cols, ell_vals, counts, shape, dtype)
    key = rows.astype(np.int64) * shape[1] + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    vals_sorted = np.asarray(vals)[order]
    uniq, inv = np.unique(key_sorted, return_inverse=True)
    summed = np.zeros(uniq.shape[0], dtype=vals_sorted.dtype)
    np.add.at(summed, inv, vals_sorted)
    urows = (uniq // shape[1]).astype(np.int64)
    ucols = (uniq % shape[1]).astype(np.int32)

    counts = np.bincount(urows, minlength=n_rows)
    width = int(counts.max()) if counts.size else 1
    ell_cols = np.tile(np.arange(n_rows, dtype=np.int32)[:, None], (1, width))
    ell_vals = np.zeros((n_rows, width), dtype=vals_sorted.dtype)
    # position within row
    row_start = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    pos = np.arange(uniq.shape[0]) - row_start[urows]
    ell_cols[urows, pos] = ucols
    ell_vals[urows, pos] = summed
    return _build_ell(ell_cols, ell_vals, counts, shape, dtype)


def _build_ell(ell_cols, ell_vals, counts, shape, dtype) -> ELLMatrix:
    """Construct an ELLMatrix, spilling outlier high-degree rows into a COO
    tail when they would inflate the padded width (e.g. the welded apex of
    the LV ellipsoid has degree ~2*n_theta while typical rows have ~15).
    The split depends only on the sparsity pattern (row counts), so
    mass/stiffness pairs split identically and stay ``combine``-compatible."""
    n_rows = shape[0]
    W = ell_cols.shape[1]
    cap = max(int(np.percentile(counts, 99)) if counts.size else 1, 4)
    if dtype is not None:
        ell_vals = ell_vals.astype(dtype)
    # numpy-backed: assembly is a host-side pipeline (stencil detection,
    # RCM, padding, value packing all read these arrays back); consumers
    # push to device once via .to_device() when host processing is done
    if W <= max(int(cap * 1.5), cap + 4):
        return ELLMatrix(cols=ell_cols.astype(np.int32), vals=ell_vals, shape=shape)
    heavy = np.nonzero(counts > cap)[0]
    tr, tc, tv = [], [], []
    for r in heavy:
        c = int(counts[r])
        tr.append(np.full(c - cap, r, dtype=np.int32))
        tc.append(ell_cols[r, cap:c].astype(np.int32))
        tv.append(ell_vals[r, cap:c])
    tail_rows = np.concatenate(tr)
    tail_cols = np.concatenate(tc)
    tail_vals = np.concatenate(tv)
    main_cols = ell_cols[:, :cap].copy()
    main_vals = ell_vals[:, :cap].copy()
    return ELLMatrix(
        cols=main_cols.astype(np.int32),
        vals=main_vals,
        shape=shape,
        tail_rows=tail_rows,
        tail_cols=tail_cols,
        tail_vals=tail_vals,
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class StencilMatrix:
    """Fixed-offset (stencil) sparse matrix: row r couples to columns
    r + offsets[k] with weights vals[r, k].

    On lexicographically-ordered structured meshes the P1 operator has a
    single global offset set (a 15-point stencil for the Kuhn tet slab), so
    the SpMV becomes K shifted fused multiply-adds with NO gather, which
    XLA fuses into one bandwidth-bound pass.  Value-level combination (``a*M.vals + b*K.vals``)
    works exactly as for ELL since mass/stiffness share the offset set.
    """

    offsets: tuple[int, ...]  # static (aux data)
    vals: jnp.ndarray  # [n_rows, K]
    shape: tuple[int, int]

    def tree_flatten(self):
        return (self.vals,), (self.offsets, self.shape)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (vals,) = children
        return cls(offsets=aux[0], vals=vals, shape=aux[1])

    @property
    def width(self) -> int:
        return len(self.offsets)

    def with_values(self, vals: jnp.ndarray) -> "StencilMatrix":
        return StencilMatrix(offsets=self.offsets, vals=vals, shape=self.shape)

    def combine(self, ca, other: "StencilMatrix | None", cb) -> "StencilMatrix":
        """``ca*self + cb*other`` for matrices sharing the offset set."""
        vals = ca * self.vals + (cb * other.vals if other is not None else 0.0)
        return self.with_values(vals)

    def diagonal(self) -> jnp.ndarray:
        k0 = self.offsets.index(0)
        return self.vals[:, k0]

    def to_device(self) -> "StencilMatrix":
        """One-shot host->device push (see :meth:`ELLMatrix.to_device`)."""
        return StencilMatrix(
            offsets=self.offsets,
            vals=jax.device_put(jnp.asarray(self.vals)),
            shape=self.shape,
        )

    def __matmul__(self, x: jnp.ndarray) -> jnp.ndarray:
        # Rows lacking a neighbor at offset d carry weight 0, so shifted
        # operands can be zero-padded unconditionally: K fused multiply-adds,
        # no gather, no scatter.
        zeros = None
        y = jnp.zeros_like(x)
        for k, d in enumerate(self.offsets):
            w = self.vals[:, k]
            if d == 0:
                y = y + w * x
                continue
            if zeros is None:
                zeros = jnp.zeros((max(abs(o) for o in self.offsets),), dtype=x.dtype)
            if d > 0:
                shifted = jnp.concatenate([x[d:], zeros[:d]])
            else:
                shifted = jnp.concatenate([zeros[: -d], x[:d]])
            y = y + w * shifted
        return y


def ell_to_stencil(A: ELLMatrix, max_offsets: int = 64) -> StencilMatrix | None:
    """Convert an ELL matrix to stencil form when a small global offset set
    exists (host-side, setup time).  Returns None otherwise."""
    if A.has_tail:
        return None
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    n, w = cols.shape
    rows = np.arange(n, dtype=np.int64)[:, None]
    offs = cols.astype(np.int64) - rows  # [n, w]
    # padding entries (col == row, val == 0) contribute offset 0 — harmless
    uniq = np.unique(offs)
    if uniq.size > max_offsets:
        return None
    K = uniq.size
    st_vals = np.zeros((n, K), dtype=vals.dtype)
    kk = np.searchsorted(uniq, offs)  # uniq is sorted; exact hits guaranteed
    np.add.at(st_vals, (np.broadcast_to(rows, offs.shape), kk), vals)
    return StencilMatrix(
        offsets=tuple(int(d) for d in uniq),
        vals=st_vals,  # numpy-backed; push with .to_device() when done
        shape=A.shape,
    )

