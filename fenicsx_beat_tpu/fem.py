"""Finite-element layer: spaces, functions, assembly — precomputed for XLA.

JAX replacement for the UFL/Basix/FFCx/DOLFINx pipeline the reference
builds on (forms at ``src/beat/monodomain_model.py:68-98``, assembly at
``src/beat/base_model.py:114-124,188-206``).  The reference needs runtime
symbolic form compilation because it solves arbitrary forms; this framework's
forms are fixed (P1 mass/stiffness with an anisotropic conductivity tensor +
marked-subdomain sources), so everything reduces to:

* host-side (numpy, setup time): element tabulation, cell geometry factors,
  COO->ELL assembly of mass/stiffness with a shared sparsity pattern,
  quadrature tables for load vectors and scalar functionals;
* device-side (jnp, inside jit): gathers, segment-sums and SpMVs over those
  precomputed static-shape tables.

Supported elements: P1/P2 (continuous Lagrange), DG0/DG1, and Quadrature
spaces — the set exercised by the reference's tests and demos
(``tests/test_monodomain_solver.py:31-37``, ``src/beat/utils.py:61-84``).
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import Mesh
from .ops.quadrature import simplex_rule
from .ops.sparse import ELLMatrix, coo_to_ell

__all__ = [
    "Element",
    "FunctionSpace",
    "functionspace",
    "Function",
    "Constant",
    "Expression",
    "interpolation_points",
    "CellGeometry",
    "cell_geometry",
    "assemble_mass_stiffness",
    "assemble_mass_stiffness_auto",
    "CellQuadData",
    "cell_quadrature",
    "facet_quadrature",
    "ScalarForm",
    "assemble_scalar",
    "integral",
    "function_integral",
    "locate_dofs_topological",
    "DirichletBC",
    "dirichletbc",
    "evaluate_function",
    "point_evaluation_tables",
    "build_transfer_matrix",
]


# ---------------------------------------------------------------------------
# Elements


def _bary(pts: np.ndarray) -> np.ndarray:
    """Barycentric coords [np, tdim+1] of reference-simplex points [np, tdim]."""
    lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, pts], axis=1)


def _edge_combos(tdim: int) -> list[tuple[int, int]]:
    return list(itertools.combinations(range(tdim + 1), 2))


def _face_combos(tdim: int) -> list[tuple[int, int, int]]:
    return list(itertools.combinations(range(tdim + 1), 3))


def _interior_multiindices(nverts: int, p: int) -> list[tuple[int, ...]]:
    """Barycentric multi-indices with every component >= 1 summing to p,
    in lexicographic order — the canonical ordering for entity-interior
    lattice dofs shared between cells."""
    out = []
    for combo in itertools.product(range(1, p), repeat=nverts - 1):
        last = p - sum(combo)
        if last >= 1:
            out.append(combo + (last,))
    # lexicographic over the leading components
    return sorted(out)


def _lattice_multiindices(tdim: int, p: int) -> np.ndarray:
    """Equispaced-lattice barycentric multi-indices [nd, tdim+1] of the
    degree-``p`` simplex Lagrange element, in the canonical dof order:
    vertices, then per-edge interior (k = multiplicity at the edge's
    second vertex), then per-face interior, then cell interior."""
    nv = tdim + 1
    rows: list[tuple[int, ...]] = []
    for i in range(nv):  # vertices
        a = [0] * nv
        a[i] = p
        rows.append(tuple(a))
    for (i, j) in _edge_combos(tdim):  # edges
        for k in range(1, p):
            a = [0] * nv
            a[i] = p - k
            a[j] = k
            rows.append(tuple(a))
    if tdim >= 2:
        for combo in _face_combos(tdim) if tdim == 3 else [tuple(range(nv))]:
            if tdim == 2 and p < 3:
                continue
            for m in _interior_multiindices(3, p):
                a = [0] * nv
                for pos, mult in zip(combo, m):
                    a[pos] = mult
                rows.append(tuple(a))
    if tdim == 3 and p >= 4:
        for m in _interior_multiindices(4, p):
            rows.append(tuple(m))
    if tdim == 1:
        pass  # edge interior above covers the 1-D cell interior
    return np.asarray(rows, dtype=np.int64)


def _silvester_factors(lam_i: np.ndarray, a: int, p: int):
    """P(λ) = prod_{k<a} (p λ - k) / a!  and its λ-derivative, at points."""
    import math

    if a == 0:
        one = np.ones_like(lam_i)
        return one, np.zeros_like(lam_i)
    terms = [p * lam_i - k for k in range(a)]
    P = np.ones_like(lam_i)
    for t in terms:
        P = P * t
    dP = np.zeros_like(lam_i)
    for k in range(a):
        prod = np.ones_like(lam_i)
        for k2 in range(a):
            if k2 != k:
                prod = prod * terms[k2]
        dP = dP + p * prod
    fact = math.factorial(a)
    return P / fact, dP / fact


@dataclass(frozen=True)
class Element:
    family: str  # "P" | "DG" | "Quadrature"
    degree: int

    @property
    def discontinuous(self) -> bool:
        return self.family in ("DG", "Quadrature")

    @property
    def family_name(self) -> str:
        return {"P": "Lagrange", "DG": "Discontinuous Lagrange", "Quadrature": "Quadrature"}[
            self.family
        ]

    def ndofs_per_cell(self, tdim: int) -> int:
        if self.family == "Quadrature":
            return simplex_rule(tdim, self.degree)[0].shape[0]
        if self.degree == 0:
            return 1
        if self.degree == 1:
            return tdim + 1
        if self.degree == 2:
            return (tdim + 1) + len(_edge_combos(tdim))
        import math

        return math.comb(self.degree + tdim, tdim)

    def dof_ref_points(self, tdim: int) -> np.ndarray:
        """Interpolation points in the reference cell, one per local dof."""
        verts = np.concatenate([np.zeros((1, tdim)), np.eye(tdim)], axis=0)
        if self.family == "Quadrature":
            return simplex_rule(tdim, self.degree)[0]
        if self.degree == 0:
            return verts.mean(axis=0, keepdims=True)
        if self.degree == 1:
            return verts
        if self.degree == 2:
            mids = np.stack([(verts[i] + verts[j]) / 2 for i, j in _edge_combos(tdim)])
            return np.concatenate([verts, mids], axis=0)
        alphas = _lattice_multiindices(tdim, self.degree)
        return (alphas[:, 1:] / self.degree).astype(np.float64)

    def tabulate(self, tdim: int, pts: np.ndarray) -> np.ndarray:
        """Basis values [np, ndofs_per_cell] at reference points [np, tdim]."""
        if self.family == "Quadrature":
            raise TypeError("Quadrature elements have no pointwise basis")
        lam = _bary(pts)
        if self.degree == 0:
            return np.ones((pts.shape[0], 1))
        if self.degree == 1:
            return lam
        if self.degree == 2:
            vert = lam * (2 * lam - 1)
            edge = np.stack([4 * lam[:, i] * lam[:, j] for i, j in _edge_combos(tdim)], axis=1)
            return np.concatenate([vert, edge], axis=1)
        # generic degree: Silvester's closed form on the equispaced lattice
        p = self.degree
        alphas = _lattice_multiindices(tdim, p)
        phi = np.ones((pts.shape[0], alphas.shape[0]))
        for d, alpha in enumerate(alphas):
            for i, a in enumerate(alpha):
                if a:
                    P, _ = _silvester_factors(lam[:, i], int(a), p)
                    phi[:, d] *= P
        return phi

    def tabulate_grad(self, tdim: int, pts: np.ndarray) -> np.ndarray:
        """Reference gradients [np, ndofs_per_cell, tdim]."""
        npts = pts.shape[0]
        lam = _bary(pts)
        # d(lam)/d(xi): lam0 -> -1 each dir; lam_i -> e_i
        dlam = np.concatenate([-np.ones((1, tdim)), np.eye(tdim)], axis=0)  # [tdim+1, tdim]
        if self.degree == 1:
            return np.broadcast_to(dlam, (npts, tdim + 1, tdim)).copy()
        if self.degree == 2:
            parts = []
            for i in range(tdim + 1):
                parts.append((4 * lam[:, i : i + 1] - 1) * dlam[i][None, :])
            for i, j in _edge_combos(tdim):
                parts.append(4 * (lam[:, i : i + 1] * dlam[j][None, :] + lam[:, j : j + 1] * dlam[i][None, :]))
            return np.stack(parts, axis=1)
        if self.degree == 0:
            return np.zeros((npts, 1, tdim))
        # generic degree: product rule over the per-coordinate Silvester
        # factors, then chain rule lambda -> xi
        p = self.degree
        alphas = _lattice_multiindices(tdim, p)
        nd = alphas.shape[0]
        grad_lam = np.zeros((npts, nd, tdim + 1))
        for d, alpha in enumerate(alphas):
            Ps, dPs = [], []
            for i, a in enumerate(alpha):
                P, dP = _silvester_factors(lam[:, i], int(a), p)
                Ps.append(P)
                dPs.append(dP)
            for i in range(tdim + 1):
                g = dPs[i].copy()
                for j in range(tdim + 1):
                    if j != i:
                        g *= Ps[j]
                grad_lam[:, d, i] = g
        return np.einsum("pdi,it->pdt", grad_lam, dlam)


_FAMILY_ALIASES = {
    "P": "P",
    "CG": "P",
    "Lagrange": "P",
    "DG": "DG",
    "dP": "DG",
    "Discontinuous Lagrange": "DG",
    "Q": "Quadrature",
    "Quad": "Quadrature",
    "Quadrature": "Quadrature",
}


# ---------------------------------------------------------------------------
# Function space


@dataclass
class FunctionSpace:
    mesh: Mesh
    element: Element
    cell_dofs: np.ndarray  # [nc, ndpc] int32
    ndofs: int
    dof_coords: np.ndarray  # [ndofs, gdim]
    dof_owner_cell: np.ndarray  # [ndofs] int32 (max adjacent cell id)
    # Blocked (vector-valued) spaces use the dolfinx interleaved layout:
    # global dof = scalar_dof * block_size + component (reference builds
    # these via basix blocked elements, utils.py:87-112 there)
    block_size: int = 1
    scalar_base: "FunctionSpace | None" = None

    @property
    def ndofs_per_cell(self) -> int:
        return self.cell_dofs.shape[1]

    @property
    def value_shape(self) -> tuple:
        return () if self.block_size == 1 else (self.block_size,)

    @property
    def scalar_space(self) -> "FunctionSpace":
        """The scalar component space (self when already scalar)."""
        return self.scalar_base if self.scalar_base is not None else self

    # dolfinx-ish compat
    @property
    def dofmap(self):
        return self

    @property
    def index_map(self):
        return self

    @property
    def size_local(self) -> int:
        return self.ndofs

    @property
    def num_ghosts(self) -> int:
        return 0

    def tabulate_dof_coordinates(self) -> np.ndarray:
        return self.dof_coords


def _space_from_element(mesh: Mesh, element: Element) -> FunctionSpace:
    tdim = mesh.tdim
    ndpc = element.ndofs_per_cell(tdim)
    nc = mesh.num_cells

    if element.family == "P" and element.degree == 1:
        cell_dofs = mesh.cells
        ndofs = mesh.num_vertices
        dof_coords = mesh.coords
    elif element.family == "P" and element.degree == 2:
        edges = mesh.entities(1)
        from .mesh import _row_searchsorted  # local helper

        order = np.lexsort(edges.T[::-1])
        sorted_edges = edges[order]
        edge_ids = np.empty((nc, len(_edge_combos(tdim))), dtype=np.int64)
        for li, (i, j) in enumerate(_edge_combos(tdim)):
            local = np.sort(mesh.cells[:, [i, j]], axis=1)
            idx = _row_searchsorted(sorted_edges, local)
            edge_ids[:, li] = order[idx]
        cell_dofs = np.concatenate(
            [mesh.cells.astype(np.int64), mesh.num_vertices + edge_ids], axis=1
        ).astype(np.int32)
        ndofs = mesh.num_vertices + edges.shape[0]
        mids = mesh.coords[edges].mean(axis=1)
        dof_coords = np.concatenate([mesh.coords, mids], axis=0)
    elif element.discontinuous:
        cell_dofs = np.arange(nc * ndpc, dtype=np.int32).reshape(nc, ndpc)
        ndofs = nc * ndpc
        refpts = element.dof_ref_points(tdim)
        geom = cell_geometry(mesh)
        # x = x0 + refpts @ E  per cell
        x0 = mesh.coords[mesh.cells[:, 0]]  # [nc, gdim]
        dof_coords = (x0[:, None, :] + np.einsum("qd,cdg->cqg", refpts, geom.edges)).reshape(
            ndofs, mesh.gdim
        )
    elif element.family == "P":
        cell_dofs, ndofs, dof_coords = _generic_lagrange_dofmap(mesh, element.degree)
    else:
        raise NotImplementedError(f"{element}")

    owner = np.full(ndofs, -1, dtype=np.int64)
    np.maximum.at(owner, cell_dofs.ravel(), np.repeat(np.arange(nc), ndpc))
    return FunctionSpace(
        mesh=mesh,
        element=element,
        cell_dofs=np.ascontiguousarray(cell_dofs, dtype=np.int32),
        ndofs=int(ndofs),
        dof_coords=dof_coords,
        dof_owner_cell=owner.astype(np.int32),
    )


def _face_interior_lookup(p: int) -> np.ndarray:
    """Table mapping a face-interior multiplicity pair (a0, a1) — with
    a2 = p - a0 - a1 implied — to its canonical slot (the lexicographic
    order of ``_interior_multiindices(3, p)``)."""
    table = np.full((p + 1, p + 1), -1, dtype=np.int64)
    for idx, m in enumerate(_interior_multiindices(3, p)):
        table[m[0], m[1]] = idx
    return table


def _generic_lagrange_dofmap(mesh: Mesh, p: int):
    """Entity-based dofmap for continuous degree-``p`` simplex Lagrange.

    Global numbering: mesh vertices, then ``p-1`` dofs per edge (ordered
    by multiplicity at the edge's larger global vertex — orientation-
    independent), then face-interior dofs per face (canonical order over
    the face's sorted global vertices), then cell-interior dofs.  The
    column order of ``cell_dofs`` matches ``_lattice_multiindices``, so
    the tabulated basis pairs with it directly.  Arbitrary degree is what
    the reference gets from Basix (``base_model.py:158-168`` there).
    """
    from .mesh import _row_searchsorted

    tdim = mesh.tdim
    nc = mesh.num_cells
    cells64 = mesh.cells.astype(np.int64)
    nvert = mesh.num_vertices
    columns: list[np.ndarray] = [cells64[:, i] for i in range(tdim + 1)]
    coords_blocks: list[np.ndarray] = [mesh.coords]

    # --- edge dofs -----------------------------------------------------
    edges = mesh.entities(1)
    n_edges = edges.shape[0]
    ne_d = p - 1
    order = np.lexsort(edges.T[::-1])
    sorted_edges = edges[order]
    edge_offset = nvert
    for (i, j) in _edge_combos(tdim):
        gi, gj = cells64[:, i], cells64[:, j]
        lo = np.minimum(gi, gj)
        hi = np.maximum(gi, gj)
        eid = order[_row_searchsorted(sorted_edges, np.stack([lo, hi], axis=1))]
        flip = gi > gj
        for k in range(1, p):  # lattice dof: multiplicity k at local vertex j
            slot = np.where(flip, p - k - 1, k - 1)
            columns.append(edge_offset + eid * ne_d + slot)
    # edge dof s (0-based) lies at multiplicity s+1 of the larger vertex
    elo = mesh.coords[np.minimum(edges[:, 0], edges[:, 1])]
    ehi = mesh.coords[np.maximum(edges[:, 0], edges[:, 1])]
    s = (np.arange(1, p) / p)[None, :, None]
    coords_blocks.append(((1 - s) * elo[:, None, :] + s * ehi[:, None, :]).reshape(-1, mesh.gdim))
    offset = edge_offset + n_edges * ne_d

    # --- face-interior dofs --------------------------------------------
    n_face_int = (p - 1) * (p - 2) // 2
    if tdim == 3 and n_face_int:
        faces = mesh.entities(2)
        n_faces = faces.shape[0]
        forder = np.lexsort(faces.T[::-1])
        sorted_faces = faces[forder]
        lookup = _face_interior_lookup(p)
        face_ms = _interior_multiindices(3, p)
        for combo in _face_combos(3):
            gv = cells64[:, combo]  # [nc, 3]
            gs = np.sort(gv, axis=1)
            fid = forder[_row_searchsorted(sorted_faces, gs)]
            rank = np.argsort(np.argsort(gv, axis=1), axis=1)  # local -> sorted pos
            for m in face_ms:
                cm = np.zeros((nc, 3), dtype=np.int64)
                for t in range(3):
                    cm[np.arange(nc), rank[:, t]] = m[t]
                slot = lookup[cm[:, 0], cm[:, 1]]
                columns.append(offset + fid * n_face_int + slot)
        fverts = mesh.coords[np.sort(faces, axis=1)]  # [nf, 3, gdim]
        mlist = np.asarray(face_ms, dtype=np.float64) / p  # [nfi, 3]
        coords_blocks.append(
            np.einsum("mk,fkg->fmg", mlist, fverts).reshape(-1, mesh.gdim)
        )
        offset += n_faces * n_face_int
    elif tdim == 2 and n_face_int:
        # triangle interior: cell-local, sequential slots in lattice order
        for t in range(n_face_int):
            columns.append(offset + np.arange(nc, dtype=np.int64) * n_face_int + t)
        mlist = np.asarray(_interior_multiindices(3, p), dtype=np.float64) / p
        cverts = mesh.coords[cells64]  # [nc, 3, gdim]
        coords_blocks.append(
            np.einsum("mk,ckg->cmg", mlist, cverts).reshape(-1, mesh.gdim)
        )
        offset += nc * n_face_int

    # --- cell-interior dofs (tets, p >= 4) -------------------------------
    if tdim == 3 and p >= 4:
        cell_ms = _interior_multiindices(4, p)
        n_int = len(cell_ms)
        for t in range(n_int):
            columns.append(offset + np.arange(nc, dtype=np.int64) * n_int + t)
        mlist = np.asarray(cell_ms, dtype=np.float64) / p
        cverts = mesh.coords[cells64]  # [nc, 4, gdim]
        coords_blocks.append(
            np.einsum("mk,ckg->cmg", mlist, cverts).reshape(-1, mesh.gdim)
        )
        offset += nc * n_int

    cell_dofs = np.stack(columns, axis=1)
    dof_coords = np.concatenate(coords_blocks, axis=0)
    assert dof_coords.shape[0] == offset
    return cell_dofs.astype(np.int32), int(offset), dof_coords


def functionspace(mesh: Mesh, element, shape: tuple | None = None) -> FunctionSpace:
    """Create a function space.

    ``element`` may be an Element, a ("family", degree) tuple, or a
    ("family", degree, (dim,)) tuple mirroring
    ``dolfinx.fem.functionspace(mesh, ("P", 1, (3,)))`` for vector-valued
    (blocked) spaces; ``shape`` may also be given separately.
    """
    if isinstance(element, tuple):
        if len(element) == 3:
            family, degree, shape = element
        else:
            family, degree = element
        element = Element(_FAMILY_ALIASES[family], int(degree))
    V = _space_from_element(mesh, element)
    bs = int(np.prod(shape)) if shape else 1
    return _blocked_space(V, bs) if bs > 1 else V


def _blocked_space(V: FunctionSpace, bs: int) -> FunctionSpace:
    """Vector-valued space over ``V`` with ``bs`` interleaved components
    (dolfinx blocked layout: dof = scalar_dof * bs + component)."""
    nc = V.cell_dofs.shape[0]
    cell_dofs = (
        V.cell_dofs[:, :, None].astype(np.int64) * bs + np.arange(bs)[None, None, :]
    ).reshape(nc, -1)
    return FunctionSpace(
        mesh=V.mesh,
        element=V.element,
        cell_dofs=cell_dofs.astype(np.int32),
        ndofs=V.ndofs * bs,
        dof_coords=np.repeat(V.dof_coords, bs, axis=0),
        dof_owner_cell=np.repeat(V.dof_owner_cell, bs),
        block_size=bs,
        scalar_base=V,
    )


# ---------------------------------------------------------------------------
# Functions & constants


class _XView:
    """Mimics dolfinx's ``Function.x``: mutable host array + scatter no-op."""

    def __init__(self, array: np.ndarray):
        self._array = array

    @property
    def array(self) -> np.ndarray:
        return self._array

    @array.setter
    def array(self, v) -> None:
        self._array[...] = v

    def scatter_forward(self) -> None:  # single-process host view
        pass


class Function:
    """A finite-element function: host dof array + its space.

    Host numpy storage keeps the dolfinx-style mutable ``.x.array`` API
    (reference uses it pervasively, e.g. ``odesolver.py:164-170``).  Device
    kernels take/return jnp arrays; the fused solver path keeps state on
    device and only syncs at save points.
    """

    def __init__(self, V: FunctionSpace, name: str | None = None, dtype=np.float64):
        self._V = V
        self.name = name or "f"
        self._array = np.zeros(V.ndofs, dtype=dtype)
        self.x = _XView(self._array)

    @property
    def function_space(self) -> FunctionSpace:
        return self._V

    def ufl_element(self):
        return self._V.element

    def copy(self) -> "Function":
        f = Function(self._V, name=self.name)
        f.x.array[:] = self.x.array
        return f

    def interpolate(self, source) -> None:
        V = self._V
        bs = V.block_size
        if isinstance(source, Expression):
            source = source.source
        if isinstance(source, Function):
            Vs = source.function_space
            if Vs.block_size != bs:
                raise ValueError(
                    f"cannot interpolate a {Vs.block_size}-component function "
                    f"into a {bs}-component space"
                )
            T = build_transfer_matrix(Vs.scalar_space, V.scalar_space)
            if bs == 1:
                self.x.array[:] = np.asarray(T @ jnp.asarray(source.x.array))
            else:
                # component-wise scalar transfer on the interleaved layout
                src = jnp.asarray(source.x.array.reshape(-1, bs))
                out = np.stack([np.asarray(T @ src[:, c]) for c in range(bs)], axis=1)
                self.x.array[:] = out.reshape(-1)
            return
        if callable(source):
            ns = V.ndofs // bs
            x = np.zeros((3, ns))
            x[: V.mesh.gdim, :] = V.scalar_space.dof_coords.T
            vals = np.asarray(source(x))
            if bs == 1:
                self.x.array[:] = np.broadcast_to(vals, (ns,))
            else:
                # callable returns [bs, n_scalar_dofs] (dolfinx convention)
                self.x.array[:] = np.broadcast_to(vals, (bs, ns)).T.reshape(-1)
            return
        raise TypeError(f"Cannot interpolate from {type(source)}")

    def eval(self, points: np.ndarray) -> np.ndarray:
        return evaluate_function(self, points)


class Constant:
    """Mutable scalar/vector constant (mirrors ``dolfinx.fem.Constant``)."""

    def __init__(self, mesh_or_value, value=None):
        if value is None:
            value = mesh_or_value
        self._value = np.asarray(value, dtype=np.float64)

    @property
    def value(self):
        return self._value if self._value.ndim else float(self._value)

    @value.setter
    def value(self, v):
        self._value = np.asarray(v, dtype=np.float64)

    def __float__(self) -> float:
        return float(self._value)

    def __len__(self) -> int:
        return self._value.shape[0] if self._value.ndim else 0

    def __array__(self, dtype=None):
        return np.asarray(self._value, dtype=dtype)


@dataclass
class Expression:
    """Interpolation-source wrapper (compat with ``dolfinx.fem.Expression``)."""

    source: Any
    points: Any = None


def interpolation_points(V: FunctionSpace):
    """Compat shim mirroring reference ``utils.py:19-23``."""
    return V.element.dof_ref_points(V.mesh.tdim)


# ---------------------------------------------------------------------------
# Cell geometry


@dataclass
class CellGeometry:
    edges: np.ndarray  # [nc, tdim, gdim] edge vectors from vertex 0
    volume: np.ndarray  # [nc]
    grads: np.ndarray  # [nc, tdim+1, gdim]  physical gradients of P1 basis
    inv_edges: np.ndarray  # [nc, tdim, gdim] rows = grad of ref coord xi_i


def _batched_det_inv(E: np.ndarray):
    """Determinant and inverse of [nc, d, d] batches via cofactors.

    ``np.linalg.det/inv`` dispatch each tiny matrix through LAPACK, which
    is the dominant setup cost at production mesh sizes (measured 110 s
    for 2.65M tets at dx=0.1 on one vCPU); the closed-form d<=3 cofactor
    path below is pure vectorized arithmetic (~1 s)."""
    def _check(det):
        if np.any(det == 0):
            raise np.linalg.LinAlgError(
                "singular cell Jacobian: mesh contains degenerate "
                "(zero-volume) cells"
            )

    d = E.shape[-1]
    if d == 1:
        det = E[:, 0, 0]
        _check(det)
        inv = (1.0 / det)[:, None, None]
        return det, inv
    if d == 2:
        a, b = E[:, 0, 0], E[:, 0, 1]
        c, dd = E[:, 1, 0], E[:, 1, 1]
        det = a * dd - b * c
        _check(det)
        inv = np.empty_like(E)
        r = 1.0 / det
        inv[:, 0, 0] = dd * r
        inv[:, 0, 1] = -b * r
        inv[:, 1, 0] = -c * r
        inv[:, 1, 1] = a * r
        return det, inv
    if d == 3:
        a = E[:, 0, 0]; b = E[:, 0, 1]; c = E[:, 0, 2]
        p = E[:, 1, 0]; q = E[:, 1, 1]; r = E[:, 1, 2]
        u = E[:, 2, 0]; v = E[:, 2, 1]; w = E[:, 2, 2]
        A = q * w - r * v
        B = r * u - p * w
        C = p * v - q * u
        det = a * A + b * B + c * C
        _check(det)
        inv = np.empty_like(E)
        s = 1.0 / det
        inv[:, 0, 0] = A * s
        inv[:, 1, 0] = B * s
        inv[:, 2, 0] = C * s
        inv[:, 0, 1] = (c * v - b * w) * s
        inv[:, 1, 1] = (a * w - c * u) * s
        inv[:, 2, 1] = (b * u - a * v) * s
        inv[:, 0, 2] = (b * r - c * q) * s
        inv[:, 1, 2] = (c * p - a * r) * s
        inv[:, 2, 2] = (a * q - b * p) * s
        return det, inv
    return np.linalg.det(E), np.linalg.inv(E)


def cell_geometry(mesh: Mesh, cells: np.ndarray | None = None) -> CellGeometry:
    """Per-cell affine geometry (edges, volume, basis gradients).

    With ``cells`` (an index array), geometry is computed/sliced for that
    subset only — a full cached geometry is sliced, otherwise just the
    subset is computed (and NOT cached): production consumers like
    stimulus quadrature touch a small marked region of a multi-GB mesh
    and must not force full-mesh materialization (~3.4 GB at dx=0.05)."""
    # Cached on the mesh instance itself: a module-level dict keyed by id()
    # can collide when a garbage-collected mesh's id is reused.
    cached = getattr(mesh, "_cell_geometry", None)
    if cached is not None:
        if cells is None:
            return cached
        cells = np.asarray(cells)
        return CellGeometry(
            edges=cached.edges[cells],
            volume=cached.volume[cells],
            grads=cached.grads[cells],
            inv_edges=cached.inv_edges[cells],
        )
    tdim, gdim = mesh.tdim, mesh.gdim
    cell_verts = mesh.cells if cells is None else mesh.cells[np.asarray(cells)]
    if tdim == gdim:
        # one-pass native path: the NumPy pipeline below is ~15 strided
        # passes over [nc, d(+1), d] temporaries — the dominant cost of
        # production-scale assembly (45 s of 59 s at dx=0.1 on one vCPU)
        from .native import p1_geometry

        nat = p1_geometry(mesh.coords, cell_verts, tdim)
        if nat is not None:
            E, vol, grads = nat
            geom = CellGeometry(
                edges=E, volume=vol, grads=grads, inv_edges=grads[:, 1:, :]
            )
            if cells is None:
                mesh._cell_geometry = geom
            return geom
    X = mesh.coords[cell_verts]  # [nc, tdim+1, gdim]
    E = X[:, 1:, :] - X[:, :1, :]  # [nc, tdim, gdim]
    if tdim == gdim:
        detJ, invE = _batched_det_inv(E)
        import math

        vol = np.abs(detJ) / math.factorial(tdim)
        # x = x0 + xi @ E  =>  dx/dxi = E^T (cols)  => dxi/dx = inv(E^T) = invE^T
        # grad_x xi_i = row i of inv(E^T)^T? Work it out: xi = (x - x0) @ invE
        # so d xi_i / d x_g = invE[g, i]  => grad xi_i = invE[:, i]
        Gi = np.transpose(invE, (0, 2, 1))  # [nc, tdim(i), gdim]
    else:
        # embedded simplex (not needed yet for PDE; used for facet areas only)
        G = np.einsum("cik,cjk->cij", E, E)
        import math

        detG, invG = _batched_det_inv(G)
        vol = np.sqrt(np.abs(detG)) / math.factorial(tdim)
        Gi = np.einsum("cij,cjk->cik", invG, E)
    g0 = -Gi.sum(axis=1, keepdims=True)
    grads = np.concatenate([g0, Gi], axis=1)  # [nc, tdim+1, gdim]
    geom = CellGeometry(edges=E, volume=vol, grads=grads, inv_edges=Gi)
    if cells is None:
        mesh._cell_geometry = geom
    return geom


# ---------------------------------------------------------------------------
# Matrix assembly (P1)


def _broadcast_cell_tensor(M_cells, nc: int, g: int) -> np.ndarray:
    """Conductivity spec -> per-cell [nc, g, g] tensor (shared by the COO
    and direct-stencil assembly pipelines; scalar/constant specs stay a
    stride-0 broadcast, which the native kernel reads without
    materializing).  The pipelines agree to summation-order rounding
    (the native one-pass kernel accumulates cell-major)."""
    Mc = np.asarray(M_cells, dtype=np.float64)
    if Mc.ndim == 0:
        Mc = np.broadcast_to(np.eye(g) * Mc, (nc, g, g))
    elif Mc.ndim == 2:
        Mc = np.broadcast_to(Mc, (nc, g, g))
    return Mc


def _p1_mass_base(d: int) -> np.ndarray:
    """Closed-form P1 simplex mass matrix / volume:
    ``(1 + delta_ij) / ((d+1)(d+2))``."""
    return (np.ones((d + 1, d + 1)) + np.eye(d + 1)) / ((d + 1) * (d + 2))


def _element_matrices_to_coo(V: FunctionSpace, Ke: np.ndarray):
    """Scatter per-cell dense matrices [nc, ndpc, ndpc] to COO triplets."""
    nd = V.ndofs_per_cell
    rows = np.repeat(V.cell_dofs, nd, axis=1).ravel()
    cols = np.tile(V.cell_dofs, (1, nd)).ravel()
    return rows, cols, Ke.reshape(-1)


def assemble_mass_stiffness_coo(
    V: FunctionSpace,
    M_cells: np.ndarray | float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """Raw COO triplets ``(rows, cols, mass_vals, stiff_vals, shape)`` of
    the consistent mass and anisotropic stiffness (duplicates unsummed,
    shared pattern).  Used by the sharded solver to renumber dofs (RCM)
    before building the device-side format — the reference delegates this
    renumbering to the DOLFINx/MPI partitioner (``geometry.py:112-139``
    there)."""
    if V.element.family == "Quadrature":
        raise NotImplementedError("PDE assembly on Quadrature spaces")
    if V.block_size != 1:
        raise NotImplementedError(
            "PDE assembly on blocked (vector) spaces — the monodomain "
            "voltage is scalar; vector spaces carry data fields (fibers)"
        )
    mesh = V.mesh
    geom = cell_geometry(mesh)
    nc, d = mesh.num_cells, mesh.tdim
    g = mesh.gdim

    Mc = _broadcast_cell_tensor(M_cells, nc, g)

    deg = V.element.degree
    if V.element.family == "P" and deg == 1:
        # closed-form fast path
        base = _p1_mass_base(d)
        Me = geom.volume[:, None, None] * base[None]
        # stiffness: vol * G_i . M . G_j
        MG = np.einsum("cgh,cjh->cjg", Mc, geom.grads)
        Ke = geom.volume[:, None, None] * np.einsum("cig,cjg->cij", geom.grads, MG)
    else:
        # exact quadrature on affine simplices: mass integrand degree 2p,
        # stiffness 2(p-1) with a cellwise-constant tensor
        pts, wts = simplex_rule(d, max(2 * deg, 2))
        N = V.element.tabulate(d, pts)  # [nq, nd]
        dN = V.element.tabulate_grad(d, pts)  # [nq, nd, d]
        import math

        W = (geom.volume * math.factorial(d))[:, None] * wts[None, :]  # [nc, nq]
        # physical gradients: affine map => dxi/dx (geom.inv_edges) is
        # constant per cell; grad_x phi = dN_ref @ dxi/dx
        dN_phys = np.einsum("qit,ctg->cqig", dN, geom.inv_edges)  # [nc,nq,nd,g]
        Me = np.einsum("cq,qi,qj->cij", W, N, N)
        MdN = np.einsum("cgh,cqjh->cqjg", Mc, dN_phys)
        Ke = np.einsum("cq,cqig,cqjg->cij", W, dN_phys, MdN)

    rows, cols, mvals = _element_matrices_to_coo(V, Me)
    _, _, kvals = _element_matrices_to_coo(V, Ke)
    return rows, cols, mvals, kvals, (V.ndofs, V.ndofs)


def assemble_mass_stiffness(
    V: FunctionSpace,
    M_cells: np.ndarray | float,
    dtype=None,
    cache_key: str | None = None,
) -> tuple[ELLMatrix, ELLMatrix]:
    """Assemble consistent mass and anisotropic stiffness with one shared
    ELL sparsity pattern, so ``A = a*Mass + b*Stiff`` is a pure value-level
    combination on device (dt can then be a traced jit argument — the
    reference instead re-assembles the PETSc matrix on dt change,
    ``base_model.py:188-194,225-230``).

    ``M_cells``: scalar, [gdim,gdim], or per-cell [nc,gdim,gdim] tensor.
    Supported spaces: any continuous/discontinuous Lagrange degree with a
    tabulated basis (P1 uses the closed-form fast path; higher degrees use
    exact quadrature — the reference's ``degree`` parameter accepts the
    same, ``base_model.py:158-168``).
    """
    if cache_key is not None:
        cached = _operator_cache_load(cache_key, V, M_cells, dtype)
        if cached is not None:
            return cached
    pair = _assemble_mass_stiffness_ell_direct(V, M_cells, dtype)
    if pair is None:
        rows, cols, mvals, kvals, shape = assemble_mass_stiffness_coo(V, M_cells)
        mass = coo_to_ell(rows, cols, mvals, shape, dtype=dtype)
        stiff = coo_to_ell(rows, cols, kvals, shape, dtype=dtype)
        pair = (mass, stiff)
    if cache_key is not None:
        _operator_cache_store(cache_key, V, M_cells, dtype, *pair)
    return pair


def _assemble_mass_stiffness_ell_direct(V: FunctionSpace, M_cells, dtype):
    """One-pass native ELL assembly for P1 on tdim == gdim meshes (fused
    geometry, width-bounded rows, COO-tail spill for high-degree rows like
    the LV apex) — the unstructured counterpart of the direct stencil
    path: no 16*nc COO triplets, no radix sort, no padding every row to
    the global max degree.  Returns ``(mass, stiff)`` or ``None`` (caller
    uses the COO pipeline)."""
    mesh = V.mesh
    if (
        V.element.family != "P"
        or V.element.degree != 1
        or V.block_size != 1
        or mesh.tdim != mesh.gdim
    ):
        return None
    from .native import p1_ell_tables_direct
    from .ops.sparse import ELLMatrix

    Mc = _broadcast_cell_tensor(M_cells, mesh.num_cells, mesh.gdim)
    nat = p1_ell_tables_direct(mesh.coords, V.cell_dofs, Mc, V.ndofs)
    if nat is None:
        return None
    ell_cols, mvals, kvals, _counts, tail = nat
    ell_cols = ell_cols.astype(np.int32)
    if dtype is not None:
        mvals, kvals = mvals.astype(dtype), kvals.astype(dtype)
    tr = tc = tm = tk = None
    if tail is not None:
        tr, tc, tm, tk = tail
        if dtype is not None:
            tm, tk = tm.astype(dtype), tk.astype(dtype)
    shape = (V.ndofs, V.ndofs)
    mass = ELLMatrix(
        cols=ell_cols, vals=mvals, shape=shape,
        tail_rows=tr, tail_cols=tc, tail_vals=tm,
    )
    stiff = ELLMatrix(
        cols=ell_cols, vals=kvals, shape=shape,
        tail_rows=tr, tail_cols=tc, tail_vals=tk,
    )
    return mass, stiff


def assemble_mass_stiffness_auto(
    V: FunctionSpace,
    M_cells: np.ndarray | float,
    dtype=None,
    cache_key: str | None = None,
):
    """Stencil-first operator assembly shared by every solve path
    (FusedMonodomainSolver, MonodomainModel precompute, ECGRecovery):
    direct stencil assembly where the mesh structure allows (no COO sort,
    no per-cell element tensors — the generic pipeline needs >30 min of
    host time at the 20M-cell dx=0.05 resolution), generic ELL otherwise,
    upgraded to stencil form when the ELL pattern turns out to be a
    global stencil.  Returns ``(mass, stiff)`` as either two
    :class:`~fenicsx_beat_tpu.ops.sparse.StencilMatrix` or two
    :class:`~fenicsx_beat_tpu.ops.sparse.ELLMatrix`."""
    from .ops.sparse import ell_to_stencil

    pair = assemble_mass_stiffness_stencil(V, M_cells, dtype=dtype, cache_key=cache_key)
    if pair is not None:
        return pair
    mass, stiff = assemble_mass_stiffness(V, M_cells, dtype=dtype, cache_key=cache_key)
    mst = ell_to_stencil(mass)
    if mst is not None:
        kst = ell_to_stencil(stiff)
        if kst is not None and kst.offsets == mst.offsets:
            return mst, kst
    return mass, stiff


# bump when assembly/packing semantics change: invalidates all cached
# operator files (they are keyed by this constant)
_OPERATOR_CACHE_SCHEMA = 2


def assemble_mass_stiffness_stencil(
    V: FunctionSpace,
    M_cells: np.ndarray | float,
    dtype=None,
    max_offsets: int = 64,
    cache_key: str | None = None,
):
    """Direct stencil-form assembly for P1 spaces whose operator has a
    small global column-offset set (lexicographically-ordered structured
    meshes).  Returns ``(mass, stiff)`` as
    :class:`~fenicsx_beat_tpu.ops.sparse.StencilMatrix`, or ``None`` when
    the offset set exceeds ``max_offsets`` (unstructured meshes).

    Scalability: the generic pipeline materializes ``nnz = 16 * num_cells``
    COO triplets and sorts them (~10 GB and >30 min of host time for the
    20M-cell dx=0.05 Niederer slab on one vCPU); here each of the 16
    element-matrix (i, j) slots scatters straight into the ``[n, K]``
    stencil table via ``np.bincount`` — no sort, no [nc, 4, 4] element
    tensor, peak extra memory a few ``[nc]`` vectors.
    """
    from .ops.sparse import StencilMatrix

    if V.element.family != "P" or V.element.degree != 1 or V.block_size != 1:
        return None
    mesh = V.mesh
    nd = V.ndofs_per_cell
    n = V.ndofs

    if cache_key is not None:
        # max_offsets participates in the key: a warm cache must never
        # hand back a wider stencil than the caller's bound allows
        cached = _stencil_cache_load(f"{cache_key}|mo{max_offsets}", V, M_cells, dtype)
        if cached is not None:
            return cached

    d, g = mesh.tdim, mesh.gdim
    Mc = _broadcast_cell_tensor(M_cells, mesh.num_cells, g)
    base = _p1_mass_base(d)

    from .native import p1_stencil_tables, p1_stencil_tables_direct

    nat = None
    if d == g:
        # fused geometry + assembly: one pass over coords/cells, nothing
        # per-cell materialized (the host's bandwidth is low and erratic —
        # see docs/DESIGN.md §9 — so bytes-not-moved is the lever; for P1
        # the cell dofs ARE mesh.cells, fem.py _space_from_element)
        nat = p1_stencil_tables_direct(mesh.coords, V.cell_dofs, Mc, max_offsets, n)
        if nat == "too_wide":
            return None
        if nat is not None:
            nat = nat[:3]
    if nat is None:
        # geometry-based native path (1D meshes, embedded manifolds, or a
        # partially-built native kit); then the numpy slot loop
        geom = cell_geometry(mesh)
        vol = geom.volume
        cd = V.cell_dofs.astype(np.int64)
        nat = p1_stencil_tables(cd, vol, geom.grads, Mc, base, max_offsets, n)
        if nat == "too_wide":
            return None
    if nat is not None:
        offs, mtab, ktab = nat
    else:
        # global offset set from per-pair unique diffs; the size check runs
        # BEFORE any Python-set materialization so unstructured meshes
        # decline after one vectorized unique, not after O(n) set inserts
        offsets: set[int] = set()
        for i in range(nd):
            for j in range(nd):
                u = np.unique(cd[:, j] - cd[:, i])
                if u.size > max_offsets:
                    return None
                offsets.update(int(v) for v in u)
                if len(offsets) > max_offsets:
                    return None
        offs = np.array(sorted(offsets), dtype=np.int64)
        K = offs.size

        mst = np.zeros(n * K)
        kst = np.zeros(n * K)
        for j in range(nd):
            # M . grad(phi_j), one [nc, g] vector at a time
            MGj = np.einsum("cgh,ch->cg", Mc, geom.grads[:, j, :])
            for i in range(nd):
                dij = cd[:, j] - cd[:, i]
                kk = np.searchsorted(offs, dij)
                lin = cd[:, i] * K + kk
                mst += np.bincount(lin, weights=vol * base[i, j], minlength=n * K)
                ke_ij = vol * np.einsum("cg,cg->c", geom.grads[:, i, :], MGj)
                kst += np.bincount(lin, weights=ke_ij, minlength=n * K)
        mtab, ktab = mst.reshape(n, K), kst.reshape(n, K)

    npdt = np.dtype(jnp.dtype(dtype).name) if dtype is not None else np.float64
    mass = StencilMatrix(
        offsets=tuple(int(v) for v in offs),
        vals=mtab.astype(npdt),
        shape=(n, n),
    )
    stiff = StencilMatrix(
        offsets=mass.offsets,
        vals=ktab.astype(npdt),
        shape=(n, n),
    )
    if cache_key is not None:
        _stencil_cache_store(
            f"{cache_key}|mo{max_offsets}", V, M_cells, dtype, mass, stiff
        )
    return mass, stiff


def _stencil_cache_load(cache_key, V, M_cells, dtype):
    path = _operator_cache_path("stencil|" + cache_key, V, M_cells, dtype)
    if not path.is_file():
        return None
    try:
        from .ops.sparse import StencilMatrix

        with np.load(path) as f:
            offs = tuple(int(v) for v in f["offsets"])
            shape = (int(f["n"]), int(f["n"]))
            return (
                StencilMatrix(offsets=offs, vals=f["mvals"], shape=shape),
                StencilMatrix(offsets=offs, vals=f["kvals"], shape=shape),
            )
    except Exception:
        return None


def _stencil_cache_store(cache_key, V, M_cells, dtype, mass, stiff):
    path = _operator_cache_path("stencil|" + cache_key, V, M_cells, dtype)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.tmp-{os.getpid()}.npz")
        np.savez(
            tmp,
            n=mass.shape[0],
            offsets=np.asarray(mass.offsets, dtype=np.int64),
            mvals=np.asarray(mass.vals),
            kvals=np.asarray(stiff.vals),
        )
        os.replace(tmp, path)
    except Exception:
        pass


def _operator_cache_path(cache_key: str, V: FunctionSpace, M_cells, dtype):
    """Disk-cache slot for an assembled (mass, stiffness) pair.

    Opt-in via ``cache_key``: the analogue of FFCx's JIT kernel cache in
    the reference stack — assembly of the 442k-node Niederer slab costs
    1-2 min of host time per process without it.  The fingerprint covers
    the mesh (coords+cells digests), the conductivity tensor bytes, the
    dtype, and a schema constant bumped on assembly-code changes, so a
    stale file is never served for different physics or a fixed bug."""
    import hashlib
    from pathlib import Path

    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    d = Path(base) / "fenicsx_beat_tpu" / "operators"
    h = hashlib.sha256()
    h.update(
        f"{_OPERATOR_CACHE_SCHEMA}|{cache_key}|{V.ndofs}|{V.mesh.num_cells}|"
        f"{V.element.family}{V.element.degree}|"
        f"{np.dtype(jnp.dtype(dtype).name) if dtype is not None else np.dtype(np.float64)}".encode()
    )
    h.update(np.ascontiguousarray(V.mesh.coords))
    h.update(np.ascontiguousarray(V.mesh.cells))
    h.update(np.ascontiguousarray(np.asarray(M_cells, dtype=np.float64)))
    return d / f"{h.hexdigest()[:16]}.npz"


def _operator_cache_load(cache_key, V, M_cells, dtype):
    path = _operator_cache_path(cache_key, V, M_cells, dtype)
    if not path.is_file():
        return None
    try:
        with np.load(path) as f:
            shape = (int(f["n"]), int(f["n"]))
            mass = ELLMatrix(cols=f["cols"], vals=f["mvals"], shape=shape)
            stiff = ELLMatrix(cols=f["cols"], vals=f["kvals"], shape=shape)
            return mass, stiff
    except Exception:
        return None


def _operator_cache_store(cache_key, V, M_cells, dtype, mass, stiff):
    if mass.has_tail or not isinstance(mass.vals, np.ndarray):
        return  # only the plain numpy-backed ELL form is cached
    path = _operator_cache_path(cache_key, V, M_cells, dtype)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        # atomic publish: write to a private temp file, then rename — a
        # concurrent writer or a kill mid-savez must never leave a torn
        # file at the final path
        tmp = path.with_name(f"{path.stem}.tmp-{os.getpid()}.npz")
        np.savez(
            tmp,
            n=mass.shape[0],
            cols=np.asarray(mass.cols),
            mvals=np.asarray(mass.vals),
            kvals=np.asarray(stiff.vals),
        )
        os.replace(tmp, path)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Quadrature data for load vectors and functionals


@jax.tree_util.register_pytree_node_class
@dataclass
class CellQuadData:
    """Static-shape quadrature tables for a (sub)domain integral.

    X: [ne, nq, gdim] physical quad points; W: [ne, nq] physical weights
    (already include |detJ|); N: [nq, nd] basis at quad points;
    dofs: [ne, nd] global dofs.  ``assemble_load`` and ``integrate`` are
    pure jnp and safe inside jit.
    """

    X: jnp.ndarray
    W: jnp.ndarray
    N: jnp.ndarray
    dofs: jnp.ndarray
    ndofs: int

    def tree_flatten(self):
        return (self.X, self.W, self.N, self.dofs), (self.ndofs,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        X, W, N, dofs = children
        return cls(X, W, N, dofs, aux[0])

    def assemble_load_host(self, fn: Callable | None = None, t=0.0) -> np.ndarray:
        """Host (numpy) twin of :meth:`assemble_load` for setup-time
        precomputes (e.g. the separable TimeWindow unit load): avoids any
        device round trip; ``fn=None`` means the unit function."""
        X = np.asarray(self.X)
        W = np.asarray(self.W)
        N = np.asarray(self.N)
        dofs = np.asarray(self.dofs)
        x = np.moveaxis(X, -1, 0)
        vals = (np.ones(X.shape[:2]) if fn is None else np.asarray(fn(x, t))) * W
        cellvals = np.einsum("eq,qd->ed", vals, N)
        b = np.zeros(self.ndofs, dtype=vals.dtype)
        np.add.at(b, dofs.ravel(), cellvals.ravel())
        return b

    def assemble_load(self, fn: Callable, t) -> jnp.ndarray:
        """b_i = sum_q W_q phi_i(x_q) fn(x_q, t)   (fn jax-traceable)."""
        x = jnp.moveaxis(self.X, -1, 0)  # [gdim, ne, nq]
        vals = fn(x, t) * self.W  # [ne, nq]
        # HIGHEST: an f32 contraction may otherwise run in TF32 on the GPU
        cellvals = jnp.einsum("eq,qd->ed", vals, self.N, precision=jax.lax.Precision.HIGHEST)
        b = jnp.zeros(self.ndofs, dtype=vals.dtype)
        return b.at[self.dofs.ravel()].add(cellvals.ravel())

    def interpolate(self, u: jnp.ndarray) -> jnp.ndarray:
        """Values of the FE function u at quad points: [ne, nq]."""
        return jnp.einsum("ed,qd->eq", u[self.dofs], self.N, precision=jax.lax.Precision.HIGHEST)

    def integrate(self, integrand: Callable, u: jnp.ndarray | None = None, t=None) -> jnp.ndarray:
        """∫ integrand(x[, u_q][, t]) over the subdomain."""
        x = jnp.moveaxis(self.X, -1, 0)
        args = [x]
        if u is not None:
            args.append(self.interpolate(u))
        if t is not None:
            args.append(t)
        return jnp.sum(self.W * integrand(*args))


def cell_quadrature(
    V: FunctionSpace, cells: np.ndarray | None = None, degree: int = 4, dtype=None
) -> CellQuadData:
    """Quadrature tables over (a subset of) cells for the space ``V``."""
    dtype = dtype or np.float64
    mesh = V.mesh
    if cells is None:
        cells = np.arange(mesh.num_cells)
        geom = cell_geometry(mesh)
        edges_c, vol_c = geom.edges, geom.volume
    else:
        # subset geometry: stimulus/electrode regions are a small marked
        # slice of a potentially multi-GB mesh — never force the full
        # per-cell geometry to materialize for them
        cells = np.asarray(cells, dtype=np.int64)
        sub = cell_geometry(mesh, cells)
        edges_c, vol_c = sub.edges, sub.volume
    pts, wts = simplex_rule(mesh.tdim, degree)
    N = V.element.tabulate(mesh.tdim, pts)  # [nq, nd]
    x0 = mesh.coords[mesh.cells[cells, 0]]
    X = x0[:, None, :] + np.einsum("qd,cdg->cqg", pts, edges_c)
    import math

    scale = math.factorial(mesh.tdim)
    W = (vol_c * scale)[:, None] * wts[None, :]
    # numpy-backed: quadrature tables are typically captured as jit-closure
    # constants, and numpy constants embed into the lowered module directly
    return CellQuadData(
        X=np.asarray(X, dtype=dtype),
        W=np.asarray(W, dtype=dtype),
        N=np.asarray(N, dtype=dtype),
        dofs=np.asarray(V.cell_dofs[cells], dtype=np.int32),
        ndofs=V.ndofs,
    )


def _facet_dofs(V: FunctionSpace, fverts: np.ndarray) -> np.ndarray:
    """Global dofs [nf, ndofs_per_facet] of a continuous Lagrange space on
    the given facets, ordered to pair with the facet element's basis
    (vertices, per-facet-edge interior, facet interior)."""
    from .mesh import _row_searchsorted

    p = V.element.degree
    mesh = V.mesh
    fdim = fverts.shape[1] - 1
    nf = fverts.shape[0]
    fverts64 = fverts.astype(np.int64)
    columns = [fverts64[:, i] for i in range(fdim + 1)]
    if p >= 2 and fdim >= 1:
        edges = mesh.entities(1)
        order = np.lexsort(edges.T[::-1])
        sorted_edges = edges[order]
        ne_d = p - 1
        nvert = mesh.num_vertices
        for (i, j) in _edge_combos(fdim):
            gi, gj = fverts64[:, i], fverts64[:, j]
            lo = np.minimum(gi, gj)
            hi = np.maximum(gi, gj)
            eid = order[_row_searchsorted(sorted_edges, np.stack([lo, hi], axis=1))]
            flip = gi > gj
            for k in range(1, p):
                slot = np.where(flip, p - k - 1, k - 1)
                columns.append(nvert + eid * ne_d + slot)
    n_face_int = (p - 1) * (p - 2) // 2
    if p >= 3 and fdim == 2:
        faces = mesh.entities(2)
        forder = np.lexsort(faces.T[::-1])
        sorted_faces = faces[forder]
        nvert = mesh.num_vertices
        face_offset = nvert + mesh.entities(1).shape[0] * (p - 1)
        lookup = _face_interior_lookup(p)
        gs = np.sort(fverts64, axis=1)
        fid = forder[_row_searchsorted(sorted_faces, gs)]
        rank = np.argsort(np.argsort(fverts64, axis=1), axis=1)
        for m in _interior_multiindices(3, p):
            cm = np.zeros((nf, 3), dtype=np.int64)
            for t in range(3):
                cm[np.arange(nf), rank[:, t]] = m[t]
            slot = lookup[cm[:, 0], cm[:, 1]]
            columns.append(face_offset + fid * n_face_int + slot)
    return np.stack(columns, axis=1)


def facet_quadrature(
    V: FunctionSpace, facets: np.ndarray, degree: int = 4, dtype=None
) -> CellQuadData:
    """Quadrature tables over boundary facets (for "ds" stimuli,
    reference ``stimulation.py:99-106``) for any continuous Lagrange
    degree (the reference gets this from Basix/FFCx)."""
    if V.element.family != "P":
        raise NotImplementedError("facet integrals implemented for Lagrange spaces")
    dtype = dtype or np.float64
    mesh = V.mesh
    p = V.element.degree
    fdim = mesh.tdim - 1
    fverts = mesh.entities(fdim)[np.asarray(facets, dtype=np.int64)]  # [nf, fdim+1]
    F = mesh.coords[fverts]  # [nf, fdim+1, gdim]
    E = F[:, 1:, :] - F[:, :1, :]
    import math

    if fdim == 0:
        area = np.ones(F.shape[0])
        pts = np.zeros((1, 0))
        wts = np.ones(1)
        N = np.ones((1, 1))
        X = F[:, :1, :]
        dofs = fverts
    else:
        G = np.einsum("cik,cjk->cij", E, E)
        area = np.sqrt(np.abs(np.linalg.det(G))) / math.factorial(fdim)
        pts, wts = simplex_rule(fdim, degree)
        facet_element = Element("P", p)
        N = facet_element.tabulate(fdim, pts)
        X = F[:, :1, :] + np.einsum("qd,cdg->cqg", pts, E)
        dofs = _facet_dofs(V, fverts) if p >= 2 else fverts
    scale = math.factorial(fdim) if fdim > 0 else 1.0
    W = (area * scale)[:, None] * wts[None, :]
    # numpy-backed, see cell_quadrature
    return CellQuadData(
        X=np.asarray(X, dtype=dtype),
        W=np.asarray(W, dtype=dtype),
        N=np.asarray(N, dtype=dtype),
        dofs=np.asarray(dofs, dtype=np.int32),
        ndofs=V.ndofs,
    )


# ---------------------------------------------------------------------------
# Scalar forms


@dataclass
class ScalarForm:
    """Lazily-assembled scalar integral (mirrors ``dolfinx.fem.form`` +
    ``assemble_scalar`` usage, e.g. reference ``tests/test_monodomain.py:59-62``
    and ``ecg.py:295-298``).  Re-reads coefficient Functions at assembly
    time, so a form built once stays valid as solutions update."""

    quad: CellQuadData
    integrand: Callable  # (x[, u_q][, t]) -> values
    coefficient: Function | None = None
    time: Constant | None = None

    def assemble(self) -> float:
        u = None
        if self.coefficient is not None:
            u = jnp.asarray(self.coefficient.x.array)
        t = None if self.time is None else jnp.asarray(float(self.time))
        return float(self.quad.integrate(self.integrand, u=u, t=t))


def assemble_scalar(form: ScalarForm) -> float:
    return form.assemble()


def integral(mesh_or_space, integrand: Callable, degree: int = 4) -> ScalarForm:
    """Form for ∫ integrand(x) dx over the whole domain."""
    V = mesh_or_space
    if isinstance(V, Mesh):
        V = functionspace(V, ("P", 1))
    return ScalarForm(quad=cell_quadrature(V, degree=degree), integrand=integrand)


def function_integral(
    u: Function, integrand: Callable, degree: int = 4, time: Constant | None = None
) -> ScalarForm:
    """Form for ∫ integrand(x, u(x)[, t]) dx — covers error norms and the
    ECG electrode integral (reference ``ecg.py:295-298``)."""
    return ScalarForm(
        quad=cell_quadrature(u.function_space, degree=degree),
        integrand=integrand,
        coefficient=u,
        time=time,
    )


# ---------------------------------------------------------------------------
# Dirichlet BCs and dof location


def locate_dofs_topological(V: FunctionSpace, dim: int, entities: np.ndarray) -> np.ndarray:
    """Dofs attached to the given mesh entities (reference:
    ``dolfinx.fem.locate_dofs_topological`` used at ``utils.py:177-178``)."""
    mesh = V.mesh
    ents = mesh.entities(dim)[np.asarray(entities, dtype=np.int64)]
    if V.element.family == "P" and V.element.degree == 1:
        return np.unique(ents.ravel()).astype(np.int32)
    if V.element.family == "P" and V.element.degree == 2:
        vert_dofs = np.unique(ents.ravel())
        if dim == 0:
            return vert_dofs.astype(np.int32)
        # add edge dofs on those entities
        edges = mesh.entities(1)
        from .mesh import _row_searchsorted

        order = np.lexsort(edges.T[::-1])
        sorted_edges = edges[order]
        edge_sets = []
        for i, j in itertools.combinations(range(ents.shape[1]), 2):
            local = np.sort(ents[:, [i, j]], axis=1)
            idx = _row_searchsorted(sorted_edges, local)
            # keep only actual mesh edges
            found = (sorted_edges[idx] == local).all(axis=1)
            edge_sets.append(order[idx[found]])
        edge_dofs = mesh.num_vertices + np.unique(np.concatenate(edge_sets))
        return np.concatenate([vert_dofs, edge_dofs]).astype(np.int32)
    if V.element.family == "P":
        if dim == 0:
            return np.unique(ents.ravel()).astype(np.int32)
        if dim == mesh.tdim - 1:
            # facets carry vertex + edge + facet-interior dofs
            return np.unique(_facet_dofs(V, ents).ravel()).astype(np.int32)
        if dim == 1:
            return np.unique(_facet_dofs(V, ents).ravel()).astype(np.int32)
    raise NotImplementedError


@dataclass
class DirichletBC:
    value: float
    dofs: np.ndarray


def dirichletbc(value: float, dofs: np.ndarray, V: FunctionSpace | None = None) -> DirichletBC:
    return DirichletBC(value=float(value), dofs=np.asarray(dofs, dtype=np.int32))


# ---------------------------------------------------------------------------
# Point evaluation & transfer


def _locate_cells(mesh: Mesh, points: np.ndarray, tol: float = 1e-10) -> np.ndarray:
    """Cell containing each point (host, vectorized barycentric test)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim == 1:
        pts = pts[None, :]
    pts = pts[:, : mesh.gdim]
    if mesh.tdim == mesh.gdim:
        # bbox-prefiltered native sweep: reads each cell's coords once and
        # needs no precomputed geometry (the fallback below reads the full
        # [nc, tdim, gdim] inverse-Jacobian array PER POINT — ~1.9 GB x
        # n_probes at dx=0.05)
        from .native import locate_points as _native_locate

        nat = _native_locate(mesh.coords, mesh.cells, pts, tol=tol)
        if nat is not None:
            return nat
    geom = cell_geometry(mesh)
    x0 = mesh.coords[mesh.cells[:, 0]]  # [nc, gdim]
    out = np.full(pts.shape[0], -1, dtype=np.int64)
    # xi = (p - x0) @ invE ; bary = [1-sum, xi]
    for pi, p in enumerate(pts):
        d = p[None, :] - x0  # [nc, gdim]
        xi = np.einsum("cg,cig->ci", d, geom.inv_edges)  # [nc, tdim]
        lam0 = 1.0 - xi.sum(axis=1)
        ok = (xi >= -tol).all(axis=1) & (lam0 >= -tol)
        hits = np.nonzero(ok)[0]
        if hits.size:
            out[pi] = hits[0]
    return out


def evaluate_function(u: Function, points: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """Evaluate ``u`` at physical points (replaces scifem.evaluate_function
    used in reference ``tests/test_utils.py:62-69``)."""
    V = u.function_space
    mesh = V.mesh
    pts = np.asarray(points, dtype=np.float64)
    squeeze = pts.ndim == 1
    if squeeze:
        pts = pts[None, :]
    cells = _locate_cells(mesh, pts, tol=tol)
    if (cells < 0).any():
        missing = pts[cells < 0]
        raise ValueError(f"Points outside mesh: {missing}")
    sub = cell_geometry(mesh, cells)
    x0 = mesh.coords[mesh.cells[cells, 0]]
    xi = np.einsum("pg,pig->pi", pts[:, : mesh.gdim] - x0, sub.inv_edges)
    if V.element.family == "Quadrature":
        raise NotImplementedError("evaluate_function on quadrature spaces")
    # tabulate is pointwise: row i of N uses reference point i (the point's
    # own cell-local coordinates), so a single vectorized call suffices.
    N = V.element.tabulate(mesh.tdim, xi)
    bs = V.block_size
    if bs == 1:
        dofs = V.cell_dofs[cells]
        vals = (u.x.array[dofs] * N).sum(axis=1)
    else:
        # component-wise over the interleaved blocked layout -> [np, bs]
        dofs = V.scalar_space.cell_dofs[cells]
        comp = u.x.array.reshape(-1, bs)
        vals = np.einsum("pic,pi->pc", comp[dofs], N)
    return vals[0] if squeeze else vals


def point_evaluation_tables(
    V: FunctionSpace, points: np.ndarray, tol: float = 1e-8
) -> tuple[np.ndarray, np.ndarray]:
    """(dofs [np, ndpc], weights [np, ndpc]) such that
    ``u(points) = (u_dofs[dofs] * weights).sum(axis=1)`` — a tiny static
    gather usable on device (e.g. probe readout inside a jitted loop)."""
    mesh = V.mesh
    pts = np.asarray(points, dtype=np.float64)
    cells = _locate_cells(mesh, pts, tol=tol)
    if (cells < 0).any():
        raise ValueError(f"Points outside mesh: {pts[cells < 0]}")
    sub = cell_geometry(mesh, cells)
    x0 = mesh.coords[mesh.cells[cells, 0]]
    xi = np.einsum("pg,pig->pi", pts[:, : mesh.gdim] - x0, sub.inv_edges)
    N = V.element.tabulate(mesh.tdim, xi)
    return V.cell_dofs[cells], N


def _transfer_cache_get(Vs: FunctionSpace, Vt: FunctionSpace):
    # Cached on the source space; each entry holds a strong ref to the target
    # space so its id() cannot be recycled while the entry is alive.
    cache = getattr(Vs, "_transfer_cache", None)
    if cache is None:
        cache = Vs._transfer_cache = {}
    entry = cache.get(id(Vt))
    return cache, (entry[1] if entry is not None else None)


def build_transfer_matrix(Vs: FunctionSpace, Vt: FunctionSpace) -> ELLMatrix:
    """Interpolation matrix T: target_dofs = T @ source_dofs.

    Replaces the reference's ``local_project`` / Expression-interpolate
    transfer between ODE and PDE spaces (``utils.py:26-58``,
    ``odesolver.py:101-115``).  For pointwise elements the target dof value
    is the source evaluated at the target dof point in the dof's owner cell
    (last-cell-wins, matching dolfinx cell-wise interpolation).  For
    Quadrature sources a mass-lumped L2 projection is used.
    """
    cache, hit = _transfer_cache_get(Vs, Vt)
    if hit is not None:
        return hit
    mesh = Vs.mesh
    nt, ns = Vt.ndofs, Vs.ndofs

    if Vs.element.family == "Quadrature":
        # lumped L2: u_i = sum_{c,q} w phi_i v_q / sum w phi_i
        quadV = Vs
        pts, wts = simplex_rule(mesh.tdim, Vs.element.degree)
        geom = cell_geometry(mesh)
        import math

        W = (geom.volume * math.factorial(mesh.tdim))[:, None] * wts[None, :]  # [nc, nq]
        Nt = Vt.element.tabulate(mesh.tdim, pts)  # [nq, ndt]
        nc = mesh.num_cells
        rows = np.repeat(Vt.cell_dofs, pts.shape[0], axis=1).ravel()
        cols = np.tile(quadV.cell_dofs, (1, Vt.ndofs_per_cell)).ravel()
        # entry (i from cell c, q) = W[c,q] * Nt[q, i]
        vals = np.einsum("cq,qd->cdq", W, Nt).ravel()
        num = coo_to_ell(rows, cols, vals, (nt, ns))
        den = np.zeros(nt)
        np.add.at(den, Vt.cell_dofs.ravel(), np.einsum("cq,qd->cd", W, Nt).ravel())
        den[den == 0] = 1.0
        T = num.with_values(num.vals / jnp.asarray(den)[:, None])
        cache[id(Vt)] = (Vt, T)
        return T

    # pointwise target dofs
    if Vt.element.family == "Quadrature":
        pts, _ = simplex_rule(mesh.tdim, Vt.element.degree)
        owner = np.repeat(np.arange(mesh.num_cells), pts.shape[0])
        ref = np.tile(pts, (mesh.num_cells, 1))
        tgt_dofs = Vt.cell_dofs.ravel()
    else:
        owner = Vt.dof_owner_cell
        # ref coords of target dof points in owner cells
        geom = cell_geometry(mesh)
        x0 = mesh.coords[mesh.cells[owner, 0]]
        ref = np.einsum("pg,pig->pi", Vt.dof_coords - x0, geom.inv_edges[owner])
        tgt_dofs = np.arange(nt)

    # evaluate source basis at each target point (tabulate is pointwise)
    Ns = Vs.element.tabulate(mesh.tdim, ref)  # [npts, nds]
    src_dofs = Vs.cell_dofs[owner]
    rows = np.repeat(tgt_dofs, Vs.ndofs_per_cell)
    cols = src_dofs.ravel()
    vals = Ns.ravel()
    T = coo_to_ell(rows, cols, vals, (nt, ns))
    cache[id(Vt)] = (Vt, T)
    return T
