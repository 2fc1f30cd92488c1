"""Smoothed-aggregation algebraic multigrid (SA-AMG) preconditioner.

JAX replacement for hypre BoomerAMG, which the reference reaches
for on every hard elliptic solve (``/root/reference/src/beat/
base_model.py:140-157`` defaults KSP to CG + ``pc_type: hypre``;
``utils.py:196-205`` uses CG + BoomerAMG for the transmural Laplace
solves).  The in-repo DCT spectral preconditioner (:mod:`.spectral`)
already collapses iteration counts on constant-coefficient structured
grids; this module covers everything else — unstructured meshes
(LV/BiV ellipsoids, Gmsh imports) and heterogeneous per-cell
conductivities — with a classical smoothed-aggregation hierarchy
(Vanek/Mandel/Brezina, Computing 56, 1996).

The host/device split:

- **Setup on host** (numpy + scipy.sparse, once per solver): strength
  graph, aggregation by vectorized Luby-style maximal-independent-set
  rounds (no Python-per-node loops — a 2M-node Python loop would
  dominate setup), tentative + smoothed
  prolongation ``P = (I - omega D^-1 A) T``, Galerkin triple products
  ``A_c = P^T A P``, per-level power-iteration estimates of
  ``lambda_max(D^-1 A)``, and a dense pseudo-inverse of the coarsest
  operator (handles the semidefinite constant-nullspace case of the
  bidomain extracellular block).
- **Application on device** (jittable, static shapes): one V-cycle per
  CG iteration, unrolled over the (static) level tuple as ELL/stencil
  SpMVs + degree-k Chebyshev polynomial smoothing — a data-parallel
  smoother: pointwise, no sequential Gauss-Seidel dependence — and one
  dense ``[nc, nc]`` matmul at the bottom.  The hierarchy is a
  registered pytree so it rides jit *operand* pytrees exactly like the
  operator value streams (no large constants in the compiled program).

With equal pre/post smoothing degrees and a zero initial guess the
V-cycle is a fixed symmetric positive (semi)definite linear operator in
the residual, hence a valid CG preconditioner.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .sparse import ELLMatrix, StencilMatrix, coo_to_ell

__all__ = [
    "AMGLevel",
    "AMGHierarchy",
    "build_amg",
    "amg_apply",
    "chebyshev_smooth",
    "operator_to_csr",
]


# ----------------------------------------------------------------------
# host-side format bridge
# ----------------------------------------------------------------------
def operator_to_csr(A):
    """Host CSR view of an :class:`ELLMatrix` or :class:`StencilMatrix`
    (numpy-backed; call before ``.to_device()``)."""
    import scipy.sparse as sp

    n, m = A.shape
    if isinstance(A, StencilMatrix):
        vals = np.asarray(A.vals)
        rows_list, cols_list, data_list = [], [], []
        r = np.arange(n, dtype=np.int64)
        for k, d in enumerate(A.offsets):
            c = r + d
            ok = (c >= 0) & (c < m) & (vals[:, k] != 0.0)
            rows_list.append(r[ok])
            cols_list.append(c[ok])
            data_list.append(vals[ok, k])
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        data = np.concatenate(data_list)
    else:
        cols2 = np.asarray(A.cols)
        vals2 = np.asarray(A.vals)
        rows = np.repeat(np.arange(n, dtype=np.int64), cols2.shape[1])
        cols = cols2.reshape(-1).astype(np.int64)
        data = vals2.reshape(-1)
        keep = data != 0.0
        rows, cols, data = rows[keep], cols[keep], data[keep]
        if A.has_tail:
            rows = np.concatenate([rows, np.asarray(A.tail_rows, dtype=np.int64)])
            cols = np.concatenate([cols, np.asarray(A.tail_cols, dtype=np.int64)])
            data = np.concatenate([data, np.asarray(A.tail_vals)])
    M = sp.csr_matrix(
        (data.astype(np.float64), (rows, cols)), shape=(n, m)
    )
    M.sum_duplicates()
    return M


def _csr_to_ell(M, dtype) -> ELLMatrix:
    M = M.tocoo()
    E = coo_to_ell(
        M.row.astype(np.int64),
        M.col.astype(np.int64),
        M.data,
        M.shape,
        dtype=dtype,
    )
    if M.shape[1] < M.shape[0]:
        # rectangular (prolongation): padding entries point at the row
        # index, which can exceed n_cols — clamp (their value is 0)
        E = ELLMatrix(
            cols=np.minimum(np.asarray(E.cols), M.shape[1] - 1).astype(np.int32),
            vals=E.vals,
            shape=E.shape,
            tail_rows=E.tail_rows,
            tail_cols=E.tail_cols,
            tail_vals=E.tail_vals,
        )
    return E


# ----------------------------------------------------------------------
# host-side setup pieces
# ----------------------------------------------------------------------
def _neighbor_max(indptr: np.ndarray, indices: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Per-row max of ``x[indices]`` over a CSR adjacency (0 for empty
    rows).  ``reduceat`` over the non-empty row starts: empty rows occupy
    no index range, so consecutive non-empty starts delimit exactly the
    non-empty rows."""
    out = np.zeros(len(indptr) - 1, dtype=x.dtype)
    nz = np.diff(indptr) > 0
    if not nz.any():
        return out
    gathered = x[indices]
    out[nz] = np.maximum.reduceat(gathered, indptr[:-1][nz])
    return out


def _strength_graph(A, theta: float):
    """Symmetric strength-of-connection graph: keep off-diagonal (i, j)
    with ``|a_ij| >= theta * sqrt(|a_ii * a_jj|)`` (the classical SA
    criterion), symmetrized."""
    import scipy.sparse as sp

    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo()
    off = C.row != C.col
    strong = off & (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    S = sp.csr_matrix(
        (np.ones(int(strong.sum()), dtype=np.int8), (C.row[strong], C.col[strong])),
        shape=A.shape,
    )
    S = S.maximum(S.T).tocsr()
    return S


def _aggregate(S, active: np.ndarray) -> tuple[np.ndarray, int]:
    """Aggregate nodes over the strength graph ``S``: Luby-style MIS
    roots (vectorized rounds), every other node joins the adjacent
    aggregate of maximal root priority, repeated transitively; strength-
    isolated leftovers become singleton aggregates.  ``active=False``
    nodes (fully decoupled rows, e.g. eliminated Dirichlet dofs with an
    identity diagonal) are excluded entirely (``agg = -1``): they never
    reach the coarse grid — the smoother alone handles them, since a
    decoupled row's Jacobi-scaled eigenvalue is 1, inside the Chebyshev
    band — which is what keeps the coarsening from stalling on large
    boundary sets.  Returns ``(agg_index [n], n_aggregates)``."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    rng = np.random.default_rng(20260818)
    pri = rng.permutation(n).astype(np.float64) + 1.0  # unique, > 0

    state = np.zeros(n, dtype=np.int8)  # 0 undecided, 1 root, 2 covered
    state[~active] = 2
    while True:
        und = state == 0
        if not und.any():
            break
        p_und = np.where(und, pri, 0.0)
        nb = _neighbor_max(indptr, indices, p_und)
        new_roots = und & (pri > nb)  # unique priorities -> strict max wins
        state[new_roots] = 1
        touched = _neighbor_max(indptr, indices, new_roots.astype(np.float64)) > 0
        state[(state == 0) & touched] = 2

    roots = np.nonzero(state == 1)[0]
    n_root = roots.size
    agg = np.full(n, -1, dtype=np.int64)
    agg[roots] = np.arange(n_root)

    # attach remaining nodes to the adjacent aggregated neighbor of max
    # priority; iterate so chains (distance >= 2 from every root) resolve
    enc = float(n_root + n + 1)
    for _ in range(n):
        un = (agg < 0) & active
        if not un.any():
            break
        # composite key: priority * enc + (agg+1) decodes both the
        # winning neighbor's priority order and its aggregate id (values
        # bounded by n*enc << 2^53, exact in float64)
        comp = np.where(agg >= 0, pri * enc + (agg + 1).astype(np.float64), 0.0)
        nb = _neighbor_max(indptr, indices, comp)
        take = un & (nb > 0)
        if not take.any():
            # strength-isolated leftovers: singleton aggregates
            rest = np.nonzero(un)[0]
            agg[rest] = n_root + np.arange(rest.size)
            n_root += rest.size
            break
        agg[take] = (nb[take] % enc).astype(np.int64) - 1
    return agg, n_root


def _per_level(val, k: int):
    """Per-level option: scalar applies everywhere, a tuple/list clamps
    to its last entry for deeper levels."""
    if isinstance(val, (tuple, list)):
        return val[min(k, len(val) - 1)]
    return val


def _estimate_lmax(A, dinv: np.ndarray, iters: int = 12) -> float:
    """Power-iteration estimate of ``lambda_max(D^-1 A)`` (host, setup
    time); 1.0 fallback for degenerate operators."""
    n = A.shape[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        if not np.isfinite(ny) or ny == 0.0:
            return 1.0
        lam = ny
        x = y / ny
    return float(lam)


# ----------------------------------------------------------------------
# device-side hierarchy
# ----------------------------------------------------------------------
@jax.tree_util.register_pytree_node_class
@dataclass
class AMGLevel:
    """One fine level: its operator, inverse diagonal, Chebyshev bound,
    and the transfer pair to the next coarser level."""

    A: ELLMatrix | StencilMatrix
    dinv: jnp.ndarray  # [n]
    lmax: jnp.ndarray  # scalar, lambda_max(D^-1 A)
    P: ELLMatrix  # [n, nc] prolongation
    R: ELLMatrix  # [nc, n] restriction (= P^T)

    def tree_flatten(self):
        return (self.A, self.dinv, self.lmax, self.P, self.R), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclass
class AMGHierarchy:
    """Static-depth SA hierarchy; ``coarse_inv`` is the dense
    (pseudo-)inverse of the coarsest Galerkin operator.  ``degree`` /
    ``lmin_frac`` are static smoother parameters (aux data — they shape
    the unrolled cycle, not the traced values)."""

    levels: tuple[AMGLevel, ...]
    coarse_inv: jnp.ndarray  # [nc, nc]
    degree: int = 2
    lmin_frac: float = 1.0 / 30.0

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), (self.degree, self.lmin_frac)

    @classmethod
    def tree_unflatten(cls, aux, children):
        levels, coarse_inv = children
        return cls(levels=tuple(levels), coarse_inv=coarse_inv,
                   degree=aux[0], lmin_frac=aux[1])

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    def to_device(self, level0_A=None) -> "AMGHierarchy":
        """One-shot host->device push (see ``ELLMatrix.to_device``).

        ``level0_A``: an already-on-device copy of the fine operator to
        share (the caller's solve path typically ships the same matrix in
        its own operand pytree — avoid holding it in HBM twice)."""
        put = jax.device_put
        levels = tuple(
            AMGLevel(
                A=(level0_A if (i == 0 and level0_A is not None) else lv.A.to_device()),
                dinv=put(jnp.asarray(lv.dinv)),
                lmax=put(jnp.asarray(lv.lmax)),
                P=lv.P.to_device(),
                R=lv.R.to_device(),
            )
            for i, lv in enumerate(self.levels)
        )
        return AMGHierarchy(
            levels=levels,
            coarse_inv=put(jnp.asarray(self.coarse_inv)),
            degree=self.degree,
            lmin_frac=self.lmin_frac,
        )


def build_amg(
    A,
    *,
    strength_theta: float | tuple = 0.05,
    omega: float | tuple = 4.0 / 3.0,
    max_levels: int = 12,
    coarse_n: int = 500,
    degree: int = 2,
    agg_passes: int | tuple = 1,
    dtype=None,
    semidefinite: bool = False,
    cache_key: str | None = None,
) -> AMGHierarchy:
    """Build an SA hierarchy for the SPD (or constant-nullspace
    semidefinite) operator ``A`` (host-backed :class:`ELLMatrix` /
    :class:`StencilMatrix`, or a ``scipy.sparse`` matrix).

    ``semidefinite=True`` keeps the coarsest solve well-posed for the
    bidomain extracellular block (nullspace = constants): the dense
    bottom solve uses an eigenvalue-thresholded pseudo-inverse.  All
    arrays stay numpy-backed; push once with
    :meth:`AMGHierarchy.to_device`.

    ``cache_key`` opts into the setup-product disk cache
    (:mod:`~fenicsx_beat_tpu.cache`): the full hierarchy (every level's
    operator, transfers, Chebyshev bounds, and the dense bottom inverse)
    is stored keyed by the operator's CSR bytes and every build option,
    so a warm second run skips the whole host-side setup (measured
    28-745 s at 79k nodes depending on options).  The build is
    deterministic (seeded MIS), so the cached product is bit-identical
    to a rebuild.

    ``strength_theta``, ``omega`` and ``agg_passes`` take a scalar (every
    level) or a tuple (level k uses entry ``min(k, len-1)``):
    ``strength_theta`` is the strength-of-connection threshold — on
    anisotropic fiber operators ``0.10`` SEMICOARSENS along fibers
    (measured at the 79k LV: 23 its vs 59 at the 0.05 default, f64
    rtol 1e-5) but coarsens only ~2.75x/level, so deep hierarchies grow
    the unrolled V-cycle — pair a fiber-aware first level with aggressive deeper levels,
    e.g. ``strength_theta=(0.10, 0.05), agg_passes=(1, 2)``.  ``omega``
    is the prolongator
    smoothing weight (0 = tentative/unsmoothed P), ``agg_passes`` the
    number of composed MIS aggregation passes per level (2 passes ~=
    16-60x coarsening).  One tuned configuration is
    ``omega=(0.0, 4/3), agg_passes=(2, 1)``: a cheap one-entry-per-row
    tentative transfer + aggressive coarsening where rows are many,
    classical smoothed aggregation below, where the cost is negligible.
    """
    import scipy.sparse as sp

    A0 = A if sp.issparse(A) else operator_to_csr(A)
    A0 = A0.tocsr()
    npdt = np.dtype(jnp.dtype(dtype).name) if dtype is not None else np.float64
    if not sp.issparse(A) and np.asarray(A.vals).dtype != npdt:
        # the level-0 device operator is the caller's own matrix object;
        # cast its values so the whole hierarchy shares one dtype
        if isinstance(A, StencilMatrix):
            A = A.with_values(np.asarray(A.vals).astype(npdt))
        else:
            A = A.with_values(
                np.asarray(A.vals).astype(npdt),
                None if A.tail_vals is None else np.asarray(A.tail_vals).astype(npdt),
            )

    slot = None
    if cache_key is not None:
        from ..cache import fingerprint, load_arrays

        # content-addressed: cache_key only OPTS IN — the slot is keyed by
        # the operator bytes + options, so different callers building the
        # same hierarchy share it (a 330k-node build costs ~10 min host)
        slot = fingerprint(
            "amg",
            (strength_theta, omega, max_levels, coarse_n,
             degree, agg_passes, npdt, semidefinite),
            (A0.indptr, A0.indices, A0.data),
        )
        cached = load_arrays(slot)
        if cached is not None:
            h = _hierarchy_from_arrays(cached, A)
            if h is not None:
                return h

    levels: list[AMGLevel] = []
    Ak = A0
    fine_ops = [A]  # level-0 device operator is the caller's own matrix
    while Ak.shape[0] > coarse_n and len(levels) < max_levels - 1:
        # fully decoupled rows (no off-diagonal entries at all — e.g.
        # masked Dirichlet dofs left with an identity diagonal) stay off
        # the coarse grid; otherwise they persist as singleton aggregates
        # at every level and the coarsening never terminates
        offdiag = Ak.copy()
        offdiag.setdiag(0.0)
        offdiag.eliminate_zeros()
        active = np.diff(offdiag.indptr) > 0
        theta_k = _per_level(strength_theta, len(levels))
        S = _strength_graph(Ak, theta_k)
        agg, n_agg = _aggregate(S, active)
        if n_agg == 0 or n_agg >= 0.9 * Ak.shape[0]:
            break  # coarsening stalled; stop and solve what we have densely
        # aggressive coarsening: compose further MIS passes on the
        # tentative-Galerkin coarse graph.  Galerkin densification makes
        # the FIRST coarse level (n/4) nearly as expensive as the fine
        # operator — one composed pass drops it to n/16-n/64 where every
        # coarse level is noise next to the fine smoother.
        for _ in range(_per_level(agg_passes, len(levels)) - 1):
            rows1 = np.nonzero(agg >= 0)[0]
            T1 = sp.csr_matrix(
                (np.ones(rows1.size), (rows1, agg[rows1])),
                shape=(Ak.shape[0], n_agg),
            )
            A1 = (T1.T @ Ak @ T1).tocsr()
            S1 = _strength_graph(A1, theta_k)
            agg1, n1 = _aggregate(S1, np.ones(n_agg, dtype=bool))
            if n1 == 0 or n1 >= 0.9 * n_agg:
                break
            agg[rows1] = agg1[agg[rows1]]
            n_agg = n1
        sizes = np.bincount(agg[agg >= 0], minlength=n_agg).astype(np.float64)
        rows_t = np.nonzero(agg >= 0)[0]
        T = sp.csr_matrix(
            (1.0 / np.sqrt(sizes[agg[rows_t]]), (rows_t, agg[rows_t])),
            shape=(Ak.shape[0], n_agg),
        )
        d = Ak.diagonal()
        dinv = np.where(d != 0.0, 1.0 / np.where(d != 0.0, d, 1.0), 0.0)
        lmax = _estimate_lmax(Ak, dinv)
        omega_k = _per_level(omega, len(levels))
        if omega_k == 0.0:
            # UNSMOOTHED aggregation (P = tentative T): the cheap-transfer
            # variant.  Smoothed P/R carry ~8-30 nnz/row; tentative T has
            # ONE entry per fine row, its transpose collides only within
            # an aggregate, and the Galerkin coarse operator keeps
            # fine-like stencil density.  Plain-aggregation convergence degrades with
            # depth, so pair ``omega=(0.0, 4/3)`` with an aggressive
            # first level: tentative-P where transfers are expensive,
            # smoothed-SA quality below, where everything is cheap.
            P = T.tocsr()
        else:
            # smoothed prolongation: P = (I - (omega/lmax) D^-1 A) T
            DinvA = sp.diags(dinv) @ Ak
            P = (T - (omega_k / lmax) * (DinvA @ T)).tocsr()
        P.eliminate_zeros()
        Ac = (P.T @ Ak @ P).tocsr()
        Ac.eliminate_zeros()
        # Order the coarse level by each aggregate's FIRST fine member:
        # aggregates are contiguous in the (already RCM'd/lexicographic)
        # fine order, so first-member order inherits the fine level's
        # bandedness for BOTH the coarse operator and — crucially — the
        # transfers: P's column per fine row becomes near-monotone, so
        # their gathers stay local.  (A separate coarse RCM also bands Ac
        # but scrambles P's columns relative to fine rows.)
        first_member = np.full(n_agg, Ak.shape[0], dtype=np.int64)
        rows_fm = np.nonzero(agg >= 0)[0]
        np.minimum.at(first_member, agg[rows_fm], rows_fm)
        cperm = np.argsort(first_member, kind="stable")
        Ac = Ac[cperm][:, cperm].tocsr()
        P = P[:, cperm].tocsr()

        fine = fine_ops[-1]
        fine_ell = _csr_to_ell(fine.tocsr(), npdt) if sp.issparse(fine) else fine
        levels.append(
            AMGLevel(
                A=fine_ell,
                dinv=dinv.astype(npdt),
                lmax=np.asarray(1.05 * lmax, dtype=npdt),
                P=_csr_to_ell(P, npdt),
                R=_csr_to_ell(P.T.tocsr(), npdt),
            )
        )
        fine_ops.append(Ac)
        Ak = Ac

    Ad = np.asarray(Ak.todense(), dtype=np.float64)
    Ad = 0.5 * (Ad + Ad.T)
    # fully-zero rows (masked Dirichlet dofs that reached the bottom when
    # the whole operator fits below coarse_n) carry zero residuals — give
    # them an inert identity diagonal so the dense factorization is valid
    zero = ~Ad.any(axis=1)
    if zero.any():
        Ad[zero, zero] = 1.0
    if semidefinite:
        coarse_inv = np.linalg.pinv(Ad, rcond=1e-10, hermitian=True)
    else:
        try:
            coarse_inv = np.linalg.inv(Ad)
        except np.linalg.LinAlgError:
            coarse_inv = np.linalg.pinv(Ad, rcond=1e-12, hermitian=True)
    h = AMGHierarchy(
        levels=tuple(levels),
        coarse_inv=coarse_inv.astype(npdt),
        degree=degree,
        lmin_frac=1.0 / 30.0,
    )
    if slot is not None:
        from ..cache import store_arrays

        store_arrays(slot, _hierarchy_to_arrays(h))
    return h


def _ell_to_arrays(out: dict, prefix: str, E: ELLMatrix) -> None:
    out[prefix + "cols"] = np.asarray(E.cols)
    out[prefix + "vals"] = np.asarray(E.vals)
    out[prefix + "shape"] = np.asarray(E.shape, dtype=np.int64)
    if E.has_tail:
        out[prefix + "tail_rows"] = np.asarray(E.tail_rows)
        out[prefix + "tail_cols"] = np.asarray(E.tail_cols)
        out[prefix + "tail_vals"] = np.asarray(E.tail_vals)


def _ell_from_arrays(d: dict, prefix: str) -> ELLMatrix:
    return ELLMatrix(
        cols=d[prefix + "cols"],
        vals=d[prefix + "vals"],
        shape=tuple(int(x) for x in d[prefix + "shape"]),
        tail_rows=d.get(prefix + "tail_rows"),
        tail_cols=d.get(prefix + "tail_cols"),
        tail_vals=d.get(prefix + "tail_vals"),
    )


def _hierarchy_to_arrays(h: AMGHierarchy) -> dict:
    """Flat array dict for the disk cache.  Level-0's ``A`` is the
    caller's own operator object (not serialized — the caller passes it
    back on load); deeper-level operators and all transfers are host
    ELL matrices."""
    out = {
        "n_levels": np.asarray(len(h.levels)),
        "coarse_inv": np.asarray(h.coarse_inv),
        "degree": np.asarray(h.degree),
        "lmin_frac": np.asarray(h.lmin_frac),
    }
    for i, lv in enumerate(h.levels):
        if i > 0:
            if not isinstance(lv.A, ELLMatrix):
                raise TypeError("coarse-level operators are ELL by construction")
            _ell_to_arrays(out, f"L{i}_A_", lv.A)
        out[f"L{i}_dinv"] = np.asarray(lv.dinv)
        out[f"L{i}_lmax"] = np.asarray(lv.lmax)
        _ell_to_arrays(out, f"L{i}_P_", lv.P)
        _ell_to_arrays(out, f"L{i}_R_", lv.R)
    return out


def _hierarchy_from_arrays(d: dict, level0_A) -> AMGHierarchy | None:
    try:
        n_levels = int(d["n_levels"])
        levels = tuple(
            AMGLevel(
                A=level0_A if i == 0 else _ell_from_arrays(d, f"L{i}_A_"),
                dinv=d[f"L{i}_dinv"],
                lmax=d[f"L{i}_lmax"],
                P=_ell_from_arrays(d, f"L{i}_P_"),
                R=_ell_from_arrays(d, f"L{i}_R_"),
            )
            for i in range(n_levels)
        )
        return AMGHierarchy(
            levels=levels,
            coarse_inv=d["coarse_inv"],
            degree=int(d["degree"]),
            lmin_frac=float(d["lmin_frac"]),
        )
    except Exception:
        return None


# ----------------------------------------------------------------------
# device-side application
# ----------------------------------------------------------------------
def chebyshev_smooth(Amv, dinv, lmax, b, x, degree: int, lmin_frac: float = 1.0 / 30.0):
    """Degree-``degree`` Chebyshev polynomial smoother on the Jacobi-
    preconditioned operator ``D^-1 A`` targeting the spectrum slice
    ``[lmin_frac*lmax, 1.01*lmax]`` (the hypre/pyamg convention).
    ``Amv`` is the matvec callable (a local matrix ``@`` or a sharded
    halo-exchange SpMV under ``shard_map``); ``x=None`` means a zero
    initial guess (saves the first SpMV).  A fixed polynomial in ``A`` —
    symmetric, so equal pre/post smoothing keeps the V-cycle SPD."""
    lo = lmin_frac * lmax
    hi = 1.01 * lmax
    th = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = th / delta
    rho = 1.0 / sigma
    if x is None:
        r = b
        x = jnp.zeros_like(b)
    else:
        r = b - Amv(x)
    d = (dinv * r) / th
    for _ in range(degree - 1):
        x = x + d
        r = r - Amv(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho * rho_new) * d + (2.0 * rho_new / delta) * (dinv * r)
        rho = rho_new
    return x + d


def amg_apply(h: AMGHierarchy, r: jnp.ndarray) -> jnp.ndarray:
    """One V(degree,degree) cycle with zero initial guess: ``z ~= A^-1 r``.
    Jittable; unrolls over the static level tuple."""

    def cycle(k: int, rk: jnp.ndarray) -> jnp.ndarray:
        if k == len(h.levels):
            # HIGHEST: an f32 matmul may otherwise run in TF32 on the GPU
            return jnp.matmul(h.coarse_inv, rk, precision=jax.lax.Precision.HIGHEST)
        lv = h.levels[k]
        Amv = lambda v: lv.A @ v  # noqa: E731
        x = chebyshev_smooth(Amv, lv.dinv, lv.lmax, rk, None, h.degree, h.lmin_frac)
        rc = lv.R @ (rk - lv.A @ x)
        x = x + (lv.P @ cycle(k + 1, rc))
        return chebyshev_smooth(Amv, lv.dinv, lv.lmax, rk, x, h.degree, h.lmin_frac)

    return cycle(0, r)
