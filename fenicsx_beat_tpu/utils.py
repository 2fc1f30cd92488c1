"""FEM helper utilities: projection, space parsing, transmural layers.

JAX counterpart of reference ``src/beat/utils.py``: cross-space
local projection (``utils.py:26-58``), string-to-space parsing
(``utils.py:61-112``), and transmural layer labeling via Laplace solves
with Dirichlet BCs (``utils.py:115-355``) — here solved by the in-repo
jitted Jacobi-CG with masked Dirichlet constraints instead of PETSc/hypre.
"""

from __future__ import annotations

import logging
import jax.numpy as jnp
import numpy as np

from . import fem
from .mesh import Mesh, MeshTags
from .ops.cg import cg

logger = logging.getLogger(__name__)

__all__ = [
    "interpolation_points",
    "local_project",
    "parse_element",
    "space_from_string",
    "laplace_solve",
    "expand_layer",
    "expand_layer_biv",
    "evaluate_function",
]

# re-exported for parity with reference utils
interpolation_points = fem.interpolation_points
evaluate_function = fem.evaluate_function


def local_project(
    v: fem.Function,
    V: fem.FunctionSpace,
    u: fem.Function | None = None,
) -> fem.Function | None:
    """Element-wise projection/interpolation between spaces
    (mirrors reference ``utils.py:26-58``)."""
    U = u if u is not None else fem.Function(V)
    if v.x.array.size == U.x.array.size:
        U.x.array[:] = v.x.array[:]
        return U
    U.interpolate(v)
    return U


def parse_element(space_string: str, mesh: Mesh, dim: int = 1) -> fem.Element:
    """Parse '{family}_{degree}' strings, e.g. 'P_1', 'DG_1', 'Quadrature_4'
    (mirrors reference ``utils.py:61-84``).  ``dim > 1`` selects a blocked
    (vector-valued) variant — applied by :func:`space_from_string`, since
    the in-repo Element is scalar and blocking lives on the space."""
    family_str, degree_str = space_string.split("_")
    aliases = {
        "Lagrange": "P",
        "P": "P",
        "CG": "P",
        "Discontinuous Lagrange": "DG",
        "DG": "DG",
        "dP": "DG",
        "Quadrature": "Quadrature",
        "Q": "Quadrature",
        "Quad": "Quadrature",
    }
    if family_str not in aliases:
        msg = f"Unknown element family: {family_str}, available families: {sorted(set(aliases))}"
        raise ValueError(msg)
    return fem.Element(aliases[family_str], int(degree_str))


def space_from_string(space_string: str, mesh: Mesh, dim: int = 1) -> fem.FunctionSpace:
    """Function space from a '{family}_{degree}' string; ``dim > 1`` builds
    a blocked vector space (reference ``utils.py:87-112``, where basix
    blocked elements carry the shape)."""
    el = parse_element(space_string, mesh, dim)
    return fem.functionspace(mesh, el, shape=(dim,) if dim > 1 else None)


def laplace_solve(
    V: fem.FunctionSpace,
    bcs: list[fem.DirichletBC],
    rtol: float = 1e-10,
    atol: float = 1e-14,
    maxiter: int = 10_000,
    precond: str = "auto",
) -> np.ndarray:
    """Solve  -Laplace(u) = 0  with Dirichlet BCs via masked PCG.

    Replaces the PETSc CG+BoomerAMG solves at reference
    ``utils.py:190-208,311-341``.  Dirichlet rows are eliminated by
    masking inside the jitted operator (free dofs solve
    K_ff u_f = -K_fb g).  ``precond='auto'`` uses the SA-AMG hierarchy
    (:mod:`.ops.amg` — the in-repo BoomerAMG counterpart) above 5k dofs,
    where Jacobi-CG's O(1/h) iteration growth starts to dominate the
    setup cost; 'jacobi' forces the diagonal path.
    """
    if precond not in ("auto", "amg", "jacobi"):
        raise ValueError(f"precond must be auto/amg/jacobi, got {precond!r}")
    _, K = fem.assemble_mass_stiffness(V, 1.0)
    n = V.ndofs
    u_bc = np.zeros(n)
    free = np.ones(n, dtype=bool)
    for bc in bcs:
        u_bc[bc.dofs] = bc.value
        free[bc.dofs] = False
    # numpy closures: embedded at lowering without a device round trip
    freej = free
    u_bcj = u_bc

    def matvec(v):
        return jnp.where(freej, K @ jnp.where(freej, v, 0.0), 0.0)

    b = jnp.where(freej, -(K @ u_bcj), 0.0)
    use_amg = precond == "amg" or (precond == "auto" and n >= 5000)
    if use_amg:
        import scipy.sparse as sp

        from .ops.amg import amg_apply, build_amg, operator_to_csr

        # explicit masked matrix D_f K D_f: Dirichlet rows become fully
        # decoupled zero rows, which the hierarchy excludes from
        # coarsening (ops/amg.py)
        D = sp.diags(free.astype(np.float64))
        hier = build_amg(D @ operator_to_csr(K) @ D).to_device()
        x, info = cg(
            matvec, b, precond=lambda r: amg_apply(hier, r),
            rtol=rtol, atol=atol, maxiter=maxiter,
        )
    else:
        diag = jnp.where(freej, K.diagonal(), 1.0)
        x, info = cg(matvec, b, precond_diag=diag, rtol=rtol, atol=atol, maxiter=maxiter)
    if not bool(info.converged):
        logger.warning(
            "Laplace CG did not converge: %d iters, residual %g",
            int(info.iterations),
            float(info.residual_norm),
        )
    return np.asarray(jnp.where(freej, x, u_bcj))


def expand_layer(
    V: fem.FunctionSpace,
    ft: MeshTags,
    endo_marker: int,
    epi_marker: int,
    endo_size: float,
    epi_size: float,
    output_mid_marker: int = 0,
    output_endo_marker: int = 1,
    output_epi_marker: int = 2,
) -> fem.Function:
    """Expand endo/epi surface markers into transmural volume layers by
    thresholding a Laplace solution (reference ``utils.py:115-222``)."""
    logger.info("Expanding endo and epi markers to the rest of the mesh")
    endo_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(endo_marker))
    epi_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(epi_marker))
    bcs = [
        fem.dirichletbc(0.0, endo_dofs, V),
        fem.dirichletbc(1.0, epi_dofs, V),
    ]
    arr = laplace_solve(V, bcs)

    uh = fem.Function(V, name="endo_epi")
    uh.x.array[:] = output_mid_marker
    uh.x.array[arr <= endo_size] = output_endo_marker
    uh.x.array[arr >= 1 - epi_size] = output_epi_marker
    return uh


def expand_layer_biv(
    V: fem.FunctionSpace,
    ft: MeshTags,
    endo_lv_marker: int,
    endo_rv_marker: int,
    epi_marker: int,
    endo_size: float,
    epi_size: float,
    output_mid_marker: int = 0,
    output_endo_marker: int = 1,
    output_epi_marker: int = 2,
) -> fem.Function:
    """Biventricular variant: two Laplace solves (LV / RV endo), combined by
    the pointwise minimum (reference ``utils.py:225-355``)."""
    logger.info("Expanding endo and epi markers to the rest of the mesh (biv)")
    endo_lv_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(endo_lv_marker))
    endo_rv_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(endo_rv_marker))
    epi_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(epi_marker))

    arr_lv = laplace_solve(
        V,
        [fem.dirichletbc(0.0, endo_lv_dofs, V), fem.dirichletbc(1.0, epi_dofs, V)],
    )
    arr_rv = laplace_solve(
        V,
        [fem.dirichletbc(0.0, endo_rv_dofs, V), fem.dirichletbc(1.0, epi_dofs, V)],
    )
    arr = np.min([arr_rv, arr_lv], axis=0)

    uh = fem.Function(V, name="endo_epi")
    uh.x.array[:] = output_mid_marker
    uh.x.array[arr <= endo_size] = output_endo_marker
    uh.x.array[arr >= 1 - epi_size] = output_epi_marker
    return uh
