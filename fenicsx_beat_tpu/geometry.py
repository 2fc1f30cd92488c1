"""Slab geometries with fiber microstructure.

JAX counterpart of reference ``src/beat/geometry.py``: structured
2D/3D slab meshes with resolution ``dx`` and constant fiber/sheet/normal
fields.  The ``comm`` argument is accepted for signature parity but unused —
distribution happens through ``jax.sharding`` over dof arrays, not mesh
partitioning (reference partitions via MPI at ``geometry.py:112-139``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .mesh import CellType, Mesh, MeshTags, create_box, create_rectangle

__all__ = [
    "Geometry",
    "get_2D_slab_microstructure",
    "get_3D_slab_microstructure",
    "get_2D_slab_mesh",
    "get_3D_slab_mesh",
    "get_2D_slab_geometry",
    "get_3D_slab_geometry",
    "get_lv_ellipsoid_geometry",
    "get_biv_ellipsoid_geometry",
]


class Geometry(NamedTuple):
    mesh: Mesh
    ffun: MeshTags | None = None
    markers: dict[str, tuple[int, int]] | None = None
    f0: np.ndarray | None = None
    s0: np.ndarray | None = None
    n0: np.ndarray | None = None


def _geometry_to_arrays(geo: Geometry) -> dict:
    out = {
        "coords": geo.mesh.coords,
        "cells": geo.mesh.cells,
        "cell_type": np.asarray(geo.mesh.cell_type.value),
    }
    if geo.ffun is not None:
        out["ffun_dim"] = np.asarray(geo.ffun.dim)
        out["ffun_indices"] = geo.ffun.indices
        out["ffun_values"] = geo.ffun.values
    if geo.markers:
        out["marker_names"] = np.asarray(sorted(geo.markers), dtype="U32")
        out["marker_vals"] = np.asarray(
            [geo.markers[k] for k in sorted(geo.markers)], dtype=np.int64
        )
    for name in ("f0", "s0", "n0"):
        v = getattr(geo, name)
        if v is not None:
            out[name] = np.asarray(v)
    return out


def _geometry_from_arrays(d: dict) -> Geometry | None:
    try:
        from .mesh import meshtags

        mesh = Mesh(
            coords=d["coords"],
            cells=d["cells"],
            cell_type=CellType(int(d["cell_type"])),
        )
        ffun = None
        if "ffun_indices" in d:
            ffun = meshtags(
                mesh, int(d["ffun_dim"]), d["ffun_indices"], d["ffun_values"]
            )
        markers = None
        if "marker_names" in d:
            markers = {
                str(k): (int(v[0]), int(v[1]))
                for k, v in zip(d["marker_names"], d["marker_vals"])
            }
        return Geometry(
            mesh=mesh, ffun=ffun, markers=markers,
            f0=d.get("f0"), s0=d.get("s0"), n0=d.get("n0"),
        )
    except Exception:
        return None


def _cached_geometry(kind: str, params: dict, build):
    """Disk-backed memoization for the deterministic mesh generators:
    the 10.6M-cell LV build costs 72.8 s of host time
    (MULTICHIP_SCALING.json); the npz round-trip is seconds.  Keyed by
    every generator parameter; products are bit-identical to a rebuild."""
    from .cache import fingerprint, load_arrays, store_arrays

    slot = fingerprint(
        "geometry",
        (kind,) + tuple(f"{k}={v!r}" for k, v in sorted(params.items())),
    )
    d = load_arrays(slot)
    if d is not None:
        geo = _geometry_from_arrays(d)
        if geo is not None:
            return geo
    geo = build()
    store_arrays(slot, _geometry_to_arrays(geo))
    return geo


def get_2D_slab_microstructure(mesh: Mesh, transverse: bool = False):
    """Constant fiber/sheet directions (reference ``geometry.py:18-44``)."""
    if transverse:
        f0 = np.array((0.0, 1.0))
        s0 = np.array((1.0, 0.0))
    else:
        f0 = np.array((1.0, 0.0))
        s0 = np.array((0.0, 1.0))
    return f0, s0


def get_3D_slab_microstructure(mesh: Mesh, transverse: bool = False):
    """Constant fiber/sheet/normal directions (reference ``geometry.py:47-75``)."""
    if transverse:
        f0 = np.array((0.0, 0.0, 1.0))
        s0 = np.array((1.0, 0.0, 0.0))
        n0 = np.array((0.0, 1.0, 0.0))
    else:
        f0 = np.array((1.0, 0.0, 0.0))
        s0 = np.array((0.0, 1.0, 0.0))
        n0 = np.array((0.0, 0.0, 1.0))
    return f0, s0, n0


def get_2D_slab_mesh(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    cell_type: CellType = CellType.triangle,
    dtype=np.float64,
) -> Mesh:
    nx = int(np.rint(Lx / dx))
    ny = int(np.rint(Ly / dx))
    return create_rectangle(
        comm, points=((0.0, 0.0), (Lx, Ly)), n=(nx, ny), cell_type=cell_type, dtype=dtype
    )


def get_3D_slab_mesh(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    cell_type: CellType = CellType.tetrahedron,
    dtype=np.float64,
) -> Mesh:
    nx = int(np.rint(Lx / dx))
    ny = int(np.rint(Ly / dx))
    nz = int(np.rint(Lz / dx))
    return create_box(
        comm,
        points=((0.0, 0.0, 0.0), (Lx, Ly, Lz)),
        n=(nx, ny, nz),
        cell_type=cell_type,
        dtype=dtype,
    )


def get_3D_slab_geometry(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    cell_type: CellType = CellType.tetrahedron,
    dtype=np.float64,
    transverse: bool = False,
) -> Geometry:
    """Reference ``geometry.py:142-180``."""
    mesh = get_3D_slab_mesh(comm, dx, Lx, Ly, Lz, cell_type, dtype)
    f0, s0, n0 = get_3D_slab_microstructure(mesh, transverse)
    return Geometry(mesh=mesh, f0=f0, s0=s0, n0=n0)


def get_2D_slab_geometry(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    cell_type: CellType = CellType.triangle,
    dtype=np.float64,
    transverse: bool = False,
) -> Geometry:
    """Reference ``geometry.py:183-218``."""
    mesh = get_2D_slab_mesh(comm, dx, Lx, Ly, cell_type, dtype)
    f0, s0 = get_2D_slab_microstructure(mesh, transverse)
    return Geometry(mesh=mesh, f0=f0, s0=s0)


def get_lv_ellipsoid_geometry(
    comm=None,
    r_short_endo: float = 2.5,
    r_short_epi: float = 3.5,
    r_long_endo: float = 9.0,
    r_long_epi: float = 9.7,
    base: float = 0.0,
    psize_ref: float = 0.3,
    fiber_angle_endo: float = 60.0,
    fiber_angle_epi: float = -60.0,
    dtype=np.float64,
    cache: bool = True,
) -> Geometry:
    """Idealized truncated-ellipsoid left ventricle with rule-based fibers.

    In-repo replacement for the external ``cardiac_geometries.mesh.
    lv_ellipsoid`` the reference demos depend on (``demos/lv_endocardial.py``
    geometry block): a structured (transmural, longitudinal,
    circumferential) grid mapped onto the shell between the endo and epi
    ellipsoids, split into Kuhn tetrahedra (opposite box faces share the
    diagonal pattern, so welding the theta seam and the apex stays
    conforming), with ENDO/EPI/BASE facet tags and a linearly rotating
    helical fiber field (``fiber_angle_endo`` -> ``fiber_angle_epi``
    across the wall, degrees).

    The long axis is x, apex at x = -r_long; the base plane sits at
    x = ``base`` (markers dict matches cardiac-geometries: ENDO/EPI/BASE).

    ``cache=True`` (default) memoizes the generated mesh + fiber field
    on disk keyed by every parameter (:mod:`~fenicsx_beat_tpu.cache`).
    """
    if cache:
        params = dict(
            r_short_endo=r_short_endo, r_short_epi=r_short_epi,
            r_long_endo=r_long_endo, r_long_epi=r_long_epi, base=base,
            psize_ref=psize_ref, fiber_angle_endo=fiber_angle_endo,
            fiber_angle_epi=fiber_angle_epi, dtype=np.dtype(dtype).name,
        )
        return _cached_geometry(
            "lv_ellipsoid", params,
            lambda: get_lv_ellipsoid_geometry(
                comm, cache=False, dtype=dtype, **{
                    k: v for k, v in params.items() if k != "dtype"
                },
            ),
        )
    import itertools as _it

    mu_base_endo = -np.arccos(np.clip(base / r_long_endo, -1.0, 1.0))
    mu_base_epi = -np.arccos(np.clip(base / r_long_epi, -1.0, 1.0))

    # resolution from target element size
    wall = r_short_epi - r_short_endo
    arc = r_long_endo * (np.pi - abs(mu_base_endo))
    circ = 2 * np.pi * r_short_endo
    nt = max(2, int(np.rint(wall / psize_ref)))
    nmu = max(8, int(np.rint(arc / psize_ref)))
    nth = max(12, int(np.rint(circ / psize_ref)))

    ts = np.linspace(0.0, 1.0, nt + 1)
    ths = np.linspace(0.0, 2 * np.pi, nth + 1)[:-1]  # periodic, no duplicate

    # node ids: apex nodes (one per t-layer) + regular grid (i_mu >= 1)
    # grid index (i_t, i_mu, i_th); i_mu = 0 is the apex ring (collapsed)
    def rs(t):
        return r_short_endo + t * (r_short_epi - r_short_endo)

    def rl(t):
        return r_long_endo + t * (r_long_epi - r_long_endo)

    def mu_base(t):
        return mu_base_endo + t * (mu_base_epi - mu_base_endo)

    n_reg = (nt + 1) * nmu * nth  # i_mu in [1..nmu]

    def gid(i_t, i_mu, i_th):
        """Global node id with apex collapse and theta wrap (vectorized)."""
        i_t = np.asarray(i_t)
        i_mu = np.asarray(i_mu)
        i_th = np.asarray(i_th) % nth
        reg = (nt + 1) + (i_t * nmu + (i_mu - 1)) * nth + i_th
        return np.where(i_mu == 0, i_t, reg)

    # coordinates
    coords = np.zeros(((nt + 1) + n_reg, 3), dtype=dtype)
    node_t = np.zeros((nt + 1) + n_reg, dtype=dtype)  # transmural coordinate
    node_mu = np.zeros_like(node_t)
    node_th = np.zeros_like(node_t)
    for i_t, t in enumerate(ts):
        coords[i_t] = (-rl(t), 0.0, 0.0)
        node_t[i_t] = t
        node_mu[i_t] = -np.pi
        mu_t = np.linspace(-np.pi, mu_base(t), nmu + 1)[1:]  # i_mu = 1..nmu
        MU, TH = np.meshgrid(mu_t, ths, indexing="ij")  # [nmu, nth]
        X = rl(t) * np.cos(MU)
        Y = rs(t) * np.sin(MU) * np.cos(TH)
        Z = rs(t) * np.sin(MU) * np.sin(TH)
        base_idx = (nt + 1) + i_t * nmu * nth
        coords[base_idx : base_idx + nmu * nth] = np.stack(
            [X.ravel(), Y.ravel(), Z.ravel()], axis=1
        )
        node_t[base_idx : base_idx + nmu * nth] = t
        node_mu[base_idx : base_idx + nmu * nth] = MU.ravel()
        node_th[base_idx : base_idx + nmu * nth] = TH.ravel()

    # Kuhn 6-tet decomposition of each (i_t, i_mu, i_th) box
    it_, imu_, ith_ = np.meshgrid(
        np.arange(nt), np.arange(nmu), np.arange(nth), indexing="ij"
    )
    it_, imu_, ith_ = it_.ravel(), imu_.ravel(), ith_.ravel()
    bases = np.stack([it_, imu_, ith_], axis=1)  # [ncubes, 3]
    e = np.eye(3, dtype=np.int64)
    tets = []
    for perm in _it.permutations(range(3)):
        a = bases
        b = bases + e[perm[0]]
        c = bases + e[perm[0]] + e[perm[1]]
        d = bases + 1
        tet = np.stack(
            [gid(*a.T), gid(*b.T), gid(*c.T), gid(*d.T)], axis=1
        )
        tets.append(tet)
    cells = np.concatenate(tets, axis=0)

    # drop degenerate tets (apex collapse produces repeated vertices)
    distinct = (
        (cells[:, 0] != cells[:, 1])
        & (cells[:, 0] != cells[:, 2])
        & (cells[:, 0] != cells[:, 3])
        & (cells[:, 1] != cells[:, 2])
        & (cells[:, 1] != cells[:, 3])
        & (cells[:, 2] != cells[:, 3])
    )
    cells = cells[distinct]
    X = coords[cells]
    vol6 = np.linalg.det(X[:, 1:] - X[:, :1])
    cells = cells[np.abs(vol6) > 1e-14]

    mesh = Mesh(coords=coords, cells=cells.astype(np.int32), cell_type=CellType.tetrahedron)

    # facet markers: ENDO (t=0), EPI (t=1), BASE (mu = mu_base(t))
    from .mesh import meshtags

    markers = {"BASE": (5, 2), "ENDO": (6, 2), "EPI": (7, 2)}
    fdim = 2
    facets = mesh.entities(fdim)
    ext = mesh.exterior_facets()
    fverts = facets[ext]
    t_f = node_t[fverts]
    mu_f = node_mu[fverts]
    tol = 1e-9
    is_endo = (t_f < tol).all(axis=1)
    is_epi = (t_f > 1.0 - tol).all(axis=1)
    mu_b = mu_base(t_f)
    is_base = (np.abs(mu_f - mu_b) < 1e-9).all(axis=1)
    idx = []
    val = []
    for sel, (m, _) in [(is_base, markers["BASE"]), (is_endo, markers["ENDO"]), (is_epi, markers["EPI"])]:
        idx.append(ext[sel])
        val.append(np.full(int(sel.sum()), m, dtype=np.int32))
    ffun = meshtags(mesh, fdim, np.concatenate(idx), np.concatenate(val))

    # rule-based helical fibers per node: f = cos(a) e_theta + sin(a) e_mu
    a = np.deg2rad(fiber_angle_endo + (fiber_angle_epi - fiber_angle_endo) * node_t)
    mu = node_mu
    th = node_th
    t = node_t
    # tangents of the parametrization (normalized)
    e_mu = np.stack(
        [-rl(t) * np.sin(mu), rs(t) * np.cos(mu) * np.cos(th), rs(t) * np.cos(mu) * np.sin(th)],
        axis=1,
    )
    e_th = np.stack(
        [np.zeros_like(mu), -rs(t) * np.sin(mu) * np.sin(th), rs(t) * np.sin(mu) * np.cos(th)],
        axis=1,
    )

    def _norm(v):
        n = np.linalg.norm(v, axis=1, keepdims=True)
        return v / np.where(n > 1e-12, n, 1.0)

    e_mu, e_th = _norm(e_mu), _norm(e_th)
    f0 = np.cos(a)[:, None] * e_th + np.sin(a)[:, None] * e_mu
    # apex nodes: e_th degenerate; fall back to the long axis
    apex = np.linalg.norm(e_th, axis=1) < 0.5
    f0[apex] = (1.0, 0.0, 0.0)
    f0 = _norm(f0)
    # sheet normal = transmural direction, sheet = n x f
    n0 = _norm(np.cross(e_mu, e_th))
    n0[apex] = (0.0, 0.0, 1.0)
    s0 = _norm(np.cross(n0, f0))

    return Geometry(mesh=mesh, ffun=ffun, markers=markers, f0=f0, s0=s0, n0=n0)


def get_biv_ellipsoid_geometry(
    comm=None,
    # LV wall (same numbers as get_lv_ellipsoid_geometry)
    r_short_endo_lv: float = 2.5,
    r_short_epi_lv: float = 3.5,
    r_long_endo_lv: float = 9.0,
    r_long_epi_lv: float = 9.7,
    # RV: larger short radius, thinner free wall, shifted toward +y,
    # shorter long axis (the right ventricle wraps the septum)
    r_short_endo_rv: float = 4.2,
    r_short_epi_rv: float = 5.0,
    r_long_endo_rv: float = 8.0,
    r_long_epi_rv: float = 8.75,
    center_rv_y: float = 2.2,
    base: float = 0.0,
    psize_ref: float = 0.3,
    fiber_angle_endo: float = 60.0,
    fiber_angle_epi: float = -60.0,
    dtype=np.float64,
    cache: bool = True,
) -> Geometry:
    """Idealized TWO-CAVITY biventricular geometry with a shared septum.

    In-repo replacement for the external ``cardiac_geometries.mesh.
    biv_ellipsoid`` the reference's BiV demo depends on
    (``/root/reference/demos/biv_endocardial.py`` geometry block) — the
    two-cavity counterpart of :func:`get_lv_ellipsoid_geometry`.  The
    tissue is the union of two truncated ellipsoid shells minus both
    cavities:

        tissue = {x <= base} ∩ (in(LV_epi) ∪ in(RV_epi))
                 \\ in(LV_endo) \\ (in(RV_endo) ∩ out(LV_epi))

    The RV cavity is carved only OUTSIDE the LV epicardial ellipsoid, so
    the LV wall portion it wraps remains tissue — that is the septum,
    genuinely shared by both cavities.  Because the branching septum
    topology admits no single product grid (the LV generator's mapped-
    grid trick cannot extend), the mesh is carved from a uniform Kuhn-tet
    background box at resolution ``psize_ref`` — the construction
    production monodomain hearts classically use (Potse et al., IEEE
    TBME 53(12), 2006, voxel hearts): boundary is staircase at O(h), all
    elements are uniform-quality Kuhn tets.

    Facet markers follow the cardiac-geometries BiV convention consumed
    by :func:`~fenicsx_beat_tpu.utils.expand_layer_biv` and the reference
    demo (``geo.markers["LV"/"RV"/"EPI"/"BASE"]``); each exterior facet
    is classified by which region the missing neighbor voxel sits in.

    Fibers are rule-based (LDRB-lite, after Bayer et al., Ann Biomed Eng
    40, 2012): the transmural coordinate ``t`` solves a Laplace problem
    (both endocardia = 0, epicardium = 1), its P1 gradient gives the
    sheet normal, the apicobasal axis projects to the local tangent
    plane, and the fiber rotates ``fiber_angle_endo -> fiber_angle_epi``
    degrees across the wall.

    ``cache=True`` (default) memoizes the generated mesh + fields on
    disk keyed by every parameter (:mod:`~fenicsx_beat_tpu.cache`).
    """
    if cache:
        params = dict(
            r_short_endo_lv=r_short_endo_lv, r_short_epi_lv=r_short_epi_lv,
            r_long_endo_lv=r_long_endo_lv, r_long_epi_lv=r_long_epi_lv,
            r_short_endo_rv=r_short_endo_rv, r_short_epi_rv=r_short_epi_rv,
            r_long_endo_rv=r_long_endo_rv, r_long_epi_rv=r_long_epi_rv,
            center_rv_y=center_rv_y, base=base, psize_ref=psize_ref,
            fiber_angle_endo=fiber_angle_endo,
            fiber_angle_epi=fiber_angle_epi, dtype=np.dtype(dtype).name,
        )
        return _cached_geometry(
            "biv_ellipsoid", params,
            lambda: get_biv_ellipsoid_geometry(
                comm, cache=False, dtype=dtype, **{
                    k: v for k, v in params.items() if k != "dtype"
                },
            ),
        )
    from .mesh import meshtags

    rl_lv = lambda t: r_long_endo_lv + t * (r_long_epi_lv - r_long_endo_lv)  # noqa: E731

    def phi(x, a_long, a_short, cy=0.0):
        return (
            (x[..., 0] / a_long) ** 2
            + ((x[..., 1] - cy) / a_short) ** 2
            + (x[..., 2] / a_short) ** 2
            - 1.0
        )

    p_lv_endo = lambda x: phi(x, r_long_endo_lv, r_short_endo_lv)  # noqa: E731
    p_lv_epi = lambda x: phi(x, r_long_epi_lv, r_short_epi_lv)  # noqa: E731
    p_rv_endo = lambda x: phi(x, r_long_endo_rv, r_short_endo_rv, center_rv_y)  # noqa: E731
    p_rv_epi = lambda x: phi(x, r_long_epi_rv, r_short_epi_rv, center_rv_y)  # noqa: E731

    def in_tissue(x):
        return (
            (x[..., 0] <= base)
            & ((p_lv_epi(x) < 0) | (p_rv_epi(x) < 0))
            & (p_lv_endo(x) >= 0)
            & ~((p_rv_endo(x) < 0) & (p_lv_epi(x) >= 0))
        )

    # background box: bbox of the two epicardial ellipsoids, truncated
    lo = np.array(
        [
            -max(r_long_epi_lv, r_long_epi_rv),
            min(-r_short_epi_lv, center_rv_y - r_short_epi_rv),
            -max(r_short_epi_lv, r_short_epi_rv),
        ]
    )
    hi = np.array(
        [
            base,
            max(r_short_epi_lv, center_rv_y + r_short_epi_rv),
            max(r_short_epi_lv, r_short_epi_rv),
        ]
    )
    n_axes = tuple(max(2, int(np.ceil((hi[a] - lo[a]) / psize_ref))) for a in range(3))
    box = create_box(
        comm, points=(tuple(lo), tuple(hi)), n=n_axes,
        cell_type=CellType.tetrahedron, dtype=dtype,
    )
    cent = box.coords[box.cells].mean(axis=1)
    keep = in_tissue(cent)
    cells_old = box.cells[keep]
    used = np.unique(cells_old)
    remap = np.full(box.num_vertices, -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    mesh = Mesh(
        coords=np.ascontiguousarray(box.coords[used]),
        cells=remap[cells_old.astype(np.int64)].astype(np.int32),
        cell_type=CellType.tetrahedron,
    )

    # exterior facet classification by the missing neighbor's location
    # (reflect the owning cell's centroid through the facet centroid)
    fdim = 2
    facets = mesh.entities(fdim)
    ext = mesh.exterior_facets()
    own = mesh.facet_to_cell(ext)
    fc = mesh.coords[facets[ext]].mean(axis=1)
    cc = mesh.coords[mesh.cells[own]].mean(axis=1)
    p_out = 2.0 * fc - cc
    h = float((hi - lo).max() / max(n_axes))
    is_base = p_out[:, 0] > base - 1e-9 * max(1.0, abs(base))
    is_base |= fc[:, 0] > base - 1e-6 * h
    is_lv = ~is_base & (p_lv_endo(p_out) < 0)
    is_rv = ~is_base & ~is_lv & (p_rv_endo(p_out) < 0) & (p_lv_epi(p_out) >= 0)
    is_epi = ~is_base & ~is_lv & ~is_rv
    markers = {"BASE": (5, 2), "LV": (6, 2), "RV": (7, 2), "EPI": (8, 2)}
    idx, val = [], []
    for sel, key in [(is_base, "BASE"), (is_lv, "LV"), (is_rv, "RV"), (is_epi, "EPI")]:
        idx.append(ext[sel])
        val.append(np.full(int(sel.sum()), markers[key][0], dtype=np.int32))
    ffun = meshtags(mesh, fdim, np.concatenate(idx), np.concatenate(val))

    # ---- LDRB-lite fibers -------------------------------------------
    from . import fem
    from .utils import laplace_solve

    V = fem.functionspace(mesh, ("P", 1))
    endo_dofs = np.unique(
        np.concatenate(
            [
                fem.locate_dofs_topological(V, fdim, ffun.find(markers["LV"][0])),
                fem.locate_dofs_topological(V, fdim, ffun.find(markers["RV"][0])),
            ]
        )
    )
    epi_dofs = fem.locate_dofs_topological(V, fdim, ffun.find(markers["EPI"][0]))
    t_node = laplace_solve(
        V,
        [fem.dirichletbc(0.0, endo_dofs, V), fem.dirichletbc(1.0, epi_dofs, V)],
    )

    # P1 gradient per cell -> averaged node normals
    X = mesh.coords[mesh.cells]  # [nc, 4, 3]
    E = X[:, 1:] - X[:, :1]  # [nc, 3, 3]
    Ginv = np.linalg.inv(E)  # rows: grad(lambda_{1..3}) = Ginv^T
    gl = np.transpose(Ginv, (0, 2, 1))  # [nc, 3(grad idx), 3(xyz)] for l1..l3
    tv = t_node[mesh.cells]  # [nc, 4]
    grad_c = np.einsum("ck,ckd->cd", tv[:, 1:] - tv[:, :1], gl)  # [nc, 3]
    n_hat = np.zeros((mesh.num_vertices, 3))
    np.add.at(n_hat, mesh.cells.ravel(), np.repeat(grad_c, 4, axis=0))

    def _norm(v):
        nn = np.linalg.norm(v, axis=1, keepdims=True)
        return v / np.where(nn > 1e-12, nn, 1.0)

    # staircase surface corners can cancel the accumulated Laplace
    # gradient exactly; fall back to the analytic outward gradient of
    # the nearer epicardial ellipsoid there
    weak = np.linalg.norm(n_hat, axis=1) < 1e-8
    if weak.any():
        xw = mesh.coords[weak]
        use_rv = p_rv_epi(xw) < p_lv_epi(xw)
        g_lv = np.stack(
            [
                xw[:, 0] / r_long_epi_lv**2,
                xw[:, 1] / r_short_epi_lv**2,
                xw[:, 2] / r_short_epi_lv**2,
            ],
            axis=1,
        )
        g_rv = np.stack(
            [
                xw[:, 0] / r_long_epi_rv**2,
                (xw[:, 1] - center_rv_y) / r_short_epi_rv**2,
                xw[:, 2] / r_short_epi_rv**2,
            ],
            axis=1,
        )
        n_hat[weak] = np.where(use_rv[:, None], g_rv, g_lv)
    n_hat = _norm(n_hat)
    # apicobasal axis projected into the wall's tangent plane
    e_x = np.array([1.0, 0.0, 0.0])
    l_raw = e_x[None] - (n_hat @ e_x)[:, None] * n_hat
    degen = np.linalg.norm(l_raw, axis=1) < 0.3  # apex cap: n ~ along x
    e_y = np.array([0.0, 1.0, 0.0])
    l_raw[degen] = e_y[None] - (n_hat[degen] @ e_y)[:, None] * n_hat[degen]
    l_hat = _norm(l_raw)
    c_hat = _norm(np.cross(n_hat, l_hat))
    alpha = np.deg2rad(
        fiber_angle_endo + (fiber_angle_epi - fiber_angle_endo) * np.clip(t_node, 0, 1)
    )
    f0 = _norm(np.cos(alpha)[:, None] * c_hat + np.sin(alpha)[:, None] * l_hat)
    s0 = n_hat
    n0 = _norm(np.cross(f0, s0))
    return Geometry(mesh=mesh, ffun=ffun, markers=markers, f0=f0, s0=s0, n0=n0)
