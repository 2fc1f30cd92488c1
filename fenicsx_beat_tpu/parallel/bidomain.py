"""Sharded fused bidomain solver: shard_map + ppermute halos + psum CG
over the stacked ``[2, n]`` (v, u_e) system, with a sharded SA-AMG
V-cycle preconditioning the elliptic extracellular block.

Multi-device counterpart of :class:`~fenicsx_beat_tpu.bidomain.
BidomainSolver`, sharing its block discretization (see that module's
docstring for the math) and :class:`ShardedMonodomainSolver`'s partition
machinery.  No reference counterpart exists at all — fenicsx-beat is
monodomain-only (its JOSS paper derives monodomain FROM this model,
``joss-paper/paper.md:42-51``) and its MPI parallelism comes from
DOLFINx/PETSc; here the whole chunk (scan over steps, stacked-CG
while_loop, halo ppermutes, V-cycles) is ONE jitted shard_map program.

Sharded AMG split ("coarse grids on fewer ranks"):

- **Level 0** (the only level whose work scales with n) smooths with the
  same halo-exchange SpMV the solve itself uses — Chebyshev polynomial
  smoothing is pointwise, so it shards for free.
- **Restriction** is computed as a per-device partial product
  ``r_c = psum_d(R[:, rows_d] @ r_d)`` — ONE psum of coarse size
  (~n/8) per V-cycle, riding ICI next to the CG dot psums.
- **Levels >= 1** run replicated on every device (coarse sizes shrink
  geometrically, so the duplicated FLOPs are bounded by the level-1
  size; the alternative — re-partitioning every level — buys little at
  pod scale and costs a halo structure per level).
- **Prolongation** is purely local: each device holds the P rows of its
  own fine nodes and reads the replicated coarse correction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import fem
from ..base_model import Status
from ..config import default_dtype
from ..conductivities import as_cell_tensors
from ..mesh import Mesh
from ..ops.amg import (
    AMGHierarchy,
    amg_apply,
    build_amg,
    chebyshev_smooth,
    operator_to_csr,
)
from ..ops.cg import CGInfo, cg
from ..telemetry import BaseMonitor, NullMonitor
from .partition import Partition1D, partition_ell, partition_stencil
from .solver import ell_adjacency, partition_stimuli

__all__ = ["ShardedBidomainSolver"]


def _coo_to_padded_ell(rows, cols, vals, n_rows, width, npdt):
    """Row-sorted COO triplets -> dense-padded ELL tables (no tail; pad
    slots carry col 0 / val 0 — a zero-weighted in-bounds gather)."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(rows.size, dtype=np.int64) - starts[rows]
    ell_cols = np.zeros((n_rows, width), dtype=np.int32)
    ell_vals = np.zeros((n_rows, width), dtype=npdt)
    ell_cols[rows, pos] = cols
    ell_vals[rows, pos] = vals
    return ell_cols, ell_vals


def _slice_transfers(hier: AMGHierarchy, part: Partition1D, npdt):
    """Device-sliced level-0 transfer tables for the sharded V-cycle.

    Returns ``(R_cols3 [nd, n1, wR], R_vals3, P_cols3 [nd, nl, wP],
    P_vals3)``: the restriction is COLUMN-sliced by fine-node ownership
    (each device computes a partial coarse product, summed by one psum);
    the prolongation is ROW-sliced (each device corrects its own fine
    nodes from the replicated coarse vector)."""
    lv0 = hier.levels[0]
    R = operator_to_csr(lv0.R).tocoo()
    Pm = operator_to_csr(lv0.P).tocoo()
    nd, nl = part.n_devices, part.n_local
    n1 = lv0.R.shape[0]

    dev_R = R.col // nl
    wR = max(
        int(max((np.bincount(R.row[dev_R == d], minlength=n1).max(initial=0))
                for d in range(nd))), 1,
    )
    dev_P = Pm.row // nl
    wP = max(
        int(max((np.bincount(Pm.row[dev_P == d] - d * nl, minlength=nl).max(initial=0))
                for d in range(nd))), 1,
    )
    R_cols3 = np.zeros((nd, n1, wR), dtype=np.int32)
    R_vals3 = np.zeros((nd, n1, wR), dtype=npdt)
    P_cols3 = np.zeros((nd, nl, wP), dtype=np.int32)
    P_vals3 = np.zeros((nd, nl, wP), dtype=npdt)
    for d in range(nd):
        sel = dev_R == d
        R_cols3[d], R_vals3[d] = _coo_to_padded_ell(
            R.row[sel], (R.col[sel] - d * nl).astype(np.int32), R.data[sel], n1, wR, npdt
        )
        sel = dev_P == d
        P_cols3[d], P_vals3[d] = _coo_to_padded_ell(
            (Pm.row[sel] - d * nl).astype(np.int64), Pm.col[sel].astype(np.int32),
            Pm.data[sel], nl, wP, npdt,
        )
    return R_cols3, R_vals3, P_cols3, P_vals3


@dataclass
class ShardedBidomainSolver:
    """Operator-splitting bidomain solver sharded over a 1-D device mesh.

    Same constructor vocabulary as :class:`~fenicsx_beat_tpu.bidomain.
    BidomainSolver` plus ``device_mesh``; node arrays shard along the
    node axis (structured slabs keep lexicographic order for the stencil
    SpMV, unstructured meshes are RCM-renumbered — identical machinery
    to :class:`ShardedMonodomainSolver`).  ``u_precond``: 'auto' builds
    the SA-AMG hierarchy for the elliptic u_e block (sharded level 0 +
    replicated coarse levels — see module docstring); 'jacobi' keeps the
    diagonal."""

    mesh: Mesh
    M_i: Any
    M_e: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    device_mesh: DeviceMesh
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0
    pde_theta: float = 0.5
    C_m: float = 1.0
    cg_rtol: float = 1e-8
    cg_atol: float = 1e-10
    cg_maxiter: int = 1000
    monitor: BaseMonitor = field(default_factory=NullMonitor)
    dtype: Any = None
    u_precond: str = "auto"
    # node-aligned ionic-model markers for dict-valued ode_fun (the same
    # contract as ShardedMonodomainSolver / the fused solvers)
    ode_markers: Any = None
    # ionic step route (ops/ionic_kernel.select_route): None = the Pallas
    # kernel on each GPU shard when the model qualifies, XLA otherwise;
    # "xla" forces the jnp model, "interpret" runs the kernel in the
    # Pallas interpreter (CPU tests)
    ionic_kernel: str | None = None

    def __post_init__(self):
        self.dtype = self.dtype or default_dtype()
        (self.axis,) = self.device_mesh.axis_names
        nd = self.device_mesh.devices.size
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"splitting theta must lie in (0, 1], got {self.theta}")
        if not 0.0 < self.pde_theta <= 1.0:
            raise ValueError(f"pde_theta must lie in (0, 1], got {self.pde_theta}")
        if self.u_precond not in ("auto", "amg", "jacobi"):
            raise ValueError(
                f"u_precond must be auto/amg/jacobi, got {self.u_precond!r}"
            )
        # multi-marker ionic models: compose into one traceable step whose
        # `parameters` are the node masks, sharded along the node axis —
        # the exact machinery ShardedMonodomainSolver uses
        self._ode_masks = None
        if isinstance(self.ode_fun, dict):
            if self.ode_markers is None:
                raise ValueError("dict-valued ode_fun requires ode_markers")
            from ..odesolver import make_multi_ode

            markers = (
                self.ode_markers.x.array
                if hasattr(self.ode_markers, "x")
                else self.ode_markers
            )
            markers = np.asarray(markers).astype(np.int64)
            if markers.shape[0] != self.mesh.num_vertices:
                raise ValueError(
                    f"ode_markers has {markers.shape[0]} entries, expected "
                    f"{self.mesh.num_vertices}"
                )
            (
                self.ode_fun,
                self.init_states,
                self._ode_masks,
                self.v_index,
            ) = make_multi_ode(
                markers,
                self.ode_fun,
                self.init_states,
                self.parameters,
                self.v_index,
                dtype=self.dtype,
            )
            self.parameters = None  # masks travel as the traced parameters
        # dtype-aware solver tolerances (bidomain.py does the same)
        if jnp.dtype(self.dtype).itemsize == 4:
            self.cg_rtol = max(self.cg_rtol, 1e-6)
            self.cg_atol = max(self.cg_atol, 1e-7)

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self.V.ndofs
        Mi = as_cell_tensors(self.M_i, self.mesh)
        Me = as_cell_tensors(self.M_e, self.mesh)
        self._perm = None
        self._iperm = None

        st_i = fem.assemble_mass_stiffness_stencil(self.V, Mi, dtype=self.dtype)
        st_e = (
            fem.assemble_mass_stiffness_stencil(self.V, Me, dtype=self.dtype)
            if st_i is not None
            else None
        )
        if st_i is not None and st_e is not None and st_i[0].offsets == st_e[0].offsets:
            mass_st, ki_st = st_i
            _, ke_st = st_e
            kie_st = ki_st.combine(1.0, ke_st, 1.0)
            part, vals_mass = partition_stencil(mass_st, nd, diag_pad=1.0)
            _, vals_ki = partition_stencil(ki_st, nd, diag_pad=0.0)
            # inert positive pad diagonal keeps the u-block Jacobi finite
            _, vals_kie = partition_stencil(kie_st, nd, diag_pad=1.0)
            self._offsets = mass_st.offsets
            self._cols = None
            self._tails = None
            kie_host = kie_st
        else:
            from ..native import rcm_ordering

            mass, k_i = fem.assemble_mass_stiffness(self.V, Mi, dtype=self.dtype)
            indptr, ucols = ell_adjacency(mass)
            perm = rcm_ordering(indptr, ucols).astype(np.int64)
            iperm = np.empty(n, dtype=np.int64)
            iperm[perm] = np.arange(n, dtype=np.int64)
            self._perm = perm
            self._iperm = iperm
            # re-assemble both conductivity pairs on the RCM-renumbered
            # mesh (solver.py does the same: the direct kernel is cheaper
            # than permuting [n, W] tables through host memory)
            pm = Mesh(
                coords=self.mesh.coords[perm],
                cells=iperm[self.mesh.cells.astype(np.int64)].astype(np.int32),
                cell_type=self.mesh.cell_type,
            )
            Vp = fem.functionspace(pm, ("P", 1))
            mass, k_i = fem.assemble_mass_stiffness(Vp, Mi, dtype=self.dtype)
            _, k_e = fem.assemble_mass_stiffness(Vp, Me, dtype=self.dtype)
            k_ie = k_i.combine(1.0, k_e, 1.0)
            part, cols_m, vals_mass, tail_m = partition_ell(mass, nd)
            part_i, cols_i, vals_ki, tail_i = partition_ell(k_i, nd)
            part_ie, cols_ie, vals_kie, tail_ie = partition_ell(k_ie, nd)
            # same mesh + assembler => one sparsity pattern, one geometry
            assert part == part_i == part_ie
            assert bool(jnp.all(cols_m == cols_i)) and bool(jnp.all(cols_m == cols_ie))
            self._offsets = None
            self._cols = cols_m
            if tail_m is not None:
                tr, tc, tvm = tail_m
                _, _, tvi = tail_i
                _, _, tvie = tail_ie
                self._tails = (tr, tc, tvm, tvi, tvie)
            else:
                self._tails = None
            kie_host = k_ie
        self.part: Partition1D = part
        self._vals_mass = vals_mass
        self._vals_ki = vals_ki
        self._vals_kie = vals_kie

        # SA-AMG hierarchy for the u_e block (nullspace = constant u_e),
        # built on the PARTITION numbering so level-0 smoothing rides the
        # same halo SpMV as the solve
        self._hier = None
        if self.u_precond in ("auto", "amg"):
            # hierarchy defaults — see bidomain.py _build_step
            self._hier = build_amg(
                kie_host, dtype=self.dtype, semidefinite=True,
                strength_theta=(0.15, 0.05), omega=0.0, coarse_n=2500,
            )
        self._u_amg = self._hier is not None  # exposed for tests

        st_part = partition_stimuli(
            self.V, self.mesh, self.I_s, part, self._perm, self._iperm, self.dtype
        )
        self._stimuli = st_part.stimuli
        self._st = st_part

        init = np.asarray(self.init_states, dtype=np.float64)
        if init.ndim == 1:
            states = np.tile(init[:, None], (1, n))
        else:
            states = init.copy()
            if self._perm is not None:
                states = states[:, self._perm]
        pad = part.n_pad - n
        if pad:
            # replicate node 0 into the padding (finite ionic state on the
            # fictitious dofs; see ShardedMonodomainSolver)
            states = np.concatenate([states, np.tile(states[:, :1], (1, pad))], axis=1)
        shard_nodes = NamedSharding(self.device_mesh, P(None, self.axis))
        shard_vec = NamedSharding(self.device_mesh, P(self.axis))
        self.states = jax.device_put(jnp.asarray(states, dtype=self.dtype), shard_nodes)
        self.u_e_padded = jax.device_put(
            jnp.zeros((part.n_pad,), dtype=self.dtype), shard_vec
        )
        npdt = np.dtype(jnp.dtype(self.dtype).name)
        # ODE parameters: node-aligned arrays (multi-marker masks) are
        # permuted/padded and threaded through shard_map along the node
        # axis; plain vectors replicate (solver.py does the same)
        self._params_sharded = False
        if self._ode_masks is not None:
            masks = self._ode_masks
            if self._perm is not None:
                masks = masks[:, self._perm]
            if pad:
                masks = np.concatenate(
                    [masks, np.tile(masks[:, :1], (1, pad))], axis=1
                )
            self._params_j = np.asarray(masks)
            self._params_sharded = True
        else:
            self._params_j = (
                None
                if self.parameters is None
                else np.asarray(self.parameters, dtype=npdt)
            )
        self._build_kernels()

    # ------------------------------------------------------------------
    def _build_kernels(self):
        part = self.part
        nd, H, n_local = part.n_devices, part.halo, part.n_local
        axis = self.axis
        theta = float(self.theta)
        pde_theta = float(self.pde_theta)
        godunov = np.isclose(theta, 1.0)
        C_m = float(self.C_m)
        v_index = self.v_index
        ode_fun = self.ode_fun
        params_j = self._params_j
        st = self._st
        windows, win_amp_idx = st.windows, st.win_amp_idx
        gen_Ns, gen_exprs, gen_amp_idx = st.gen_Ns, st.gen_exprs, st.gen_amp_idx
        rtol, atol, maxiter = self.cg_rtol, self.cg_atol, self.cg_maxiter
        params_sharded = self._params_sharded
        from ..device import platform_of
        from ..ops.ionic_kernel import make_ionic_step

        # node-aligned (sharded) parameters are traced per shard and take
        # the XLA route; the route is exposed for tests and benchmarks
        self.ionic_route, ionic_step = make_ionic_step(
            ode_fun,
            self.states.shape[0],
            params_j,
            v_index,
            platform_of(self.states),
            self.ionic_kernel,
        )

        def ionic(states, t, dt, pnode):
            if params_sharded:
                return ode_fun(states=states, t=t, parameters=pnode, dt=dt)
            return ionic_step(states, states[v_index], t, dt)
        fwd = [(i, i + 1) for i in range(nd - 1)]
        bwd = [(i + 1, i) for i in range(nd - 1)]
        npdt = np.dtype(jnp.dtype(self.dtype).name)

        def halo_extend(x_loc):
            if H == 0 or nd == 1:
                pad = jnp.zeros((H,), dtype=x_loc.dtype)
                return jnp.concatenate([pad, x_loc, pad])
            left = jax.lax.ppermute(x_loc[-H:], axis, fwd)
            right = jax.lax.ppermute(x_loc[:H], axis, bwd)
            return jnp.concatenate([left, x_loc, right])

        offsets = self._offsets
        if offsets is not None:
            k0 = offsets.index(0)

            def spmv(vals_loc, cols_loc, x_loc, tail_loc=None):
                x_ext = halo_extend(x_loc)
                y = vals_loc[:, k0] * x_ext[H : H + n_local]
                for k, d in enumerate(offsets):
                    if d == 0:
                        continue
                    y = y + vals_loc[:, k] * jax.lax.dynamic_slice(
                        x_ext, (H + d,), (n_local,)
                    )
                return y

            def diag_of(A_vals, cols_loc, tail_loc=None):
                return A_vals[:, k0]

        else:

            def spmv(vals_loc, cols_loc, x_loc, tail_loc=None):
                x_ext = halo_extend(x_loc)
                y = jnp.sum(vals_loc * x_ext[cols_loc], axis=1)
                if tail_loc is not None:
                    tr, tc, tv = tail_loc
                    y = y.at[tr].add(tv * x_ext[tc])
                return y

            def diag_of(A_vals, cols_loc, tail_loc=None):
                rows = jnp.arange(n_local, dtype=cols_loc.dtype)[:, None] + H
                d = jnp.sum(jnp.where(cols_loc == rows, A_vals, 0.0), axis=1)
                if tail_loc is not None:
                    tr, tc, tv = tail_loc
                    d = d.at[tr].add(jnp.where(tc == tr + H, tv, 0.0))
                return d

        n_real = part.n_global
        dev_starts = np.arange(nd) * n_local
        real_per_dev = np.clip(n_real - dev_starts, 0, n_local)

        def real_mask(dtype):
            idx = jax.lax.axis_index(axis)
            k = jnp.asarray(real_per_dev)[idx]
            return (jnp.arange(n_local) < k).astype(dtype)

        def pdot(a, b):
            # stacked [2, n_local] inner product over REAL dofs only
            mask = real_mask(a.dtype)
            return jax.lax.psum(jnp.vdot(a * mask, b), axis)

        def pmean_u(x_u):
            mask = real_mask(x_u.dtype)
            return jax.lax.psum(jnp.sum(x_u * mask), axis) / n_real

        # ---- sharded AMG V-cycle pieces (host setup) ------------------
        hier = self._hier
        if hier is not None and hier.levels:
            R_cols3, R_vals3, P_cols3, P_vals3 = _slice_transfers(hier, part, npdt)
            lv0 = hier.levels[0]
            dinv0 = np.ones(part.n_pad, dtype=npdt)
            dinv0[:n_real] = np.asarray(lv0.dinv)
            dinv0 = dinv0.reshape(nd, n_local)
            lmax0 = np.asarray(lv0.lmax, dtype=npdt)
            sub_hier = AMGHierarchy(
                levels=hier.levels[1:],
                coarse_inv=hier.coarse_inv,
                degree=hier.degree,
                lmin_frac=hier.lmin_frac,
            )
            amg_mode = "multilevel"
        elif hier is not None:
            # operator below coarse_n: the "hierarchy" is one dense
            # pseudo-inverse; gather the (small) residual and solve
            R_cols3 = R_vals3 = P_cols3 = P_vals3 = np.zeros((nd, 1, 1), dtype=npdt)
            R_cols3 = R_cols3.astype(np.int32)
            P_cols3 = P_cols3.astype(np.int32)
            dinv0 = np.ones((nd, n_local), dtype=npdt)
            lmax0 = np.asarray(1.0, dtype=npdt)
            sub_hier = AMGHierarchy(
                levels=(), coarse_inv=hier.coarse_inv,
                degree=hier.degree, lmin_frac=hier.lmin_frac,
            )
            amg_mode = "dense"
        else:
            R_cols3 = P_cols3 = np.zeros((nd, 1, 1), dtype=np.int32)
            R_vals3 = P_vals3 = np.zeros((nd, 1, 1), dtype=npdt)
            dinv0 = np.ones((nd, n_local), dtype=npdt)
            lmax0 = np.asarray(1.0, dtype=npdt)
            sub_hier = None
            amg_mode = "jacobi"
        degree = hier.degree if hier is not None else 0
        lmin_frac = hier.lmin_frac if hier is not None else 0.0

        def local_chunk(
            states_loc, u_loc, cols3, vm3, vki3, vkie3,
            tr3, tc3, tvm3, tvi3, tvie3,
            Rc3, Rv3, Pc3, Pv3, dinv03, lmax0_, subh,
            b_units, gq, pnode, t0, dt, amps, n_steps,
        ):
            cols_loc = cols3[0]
            vm, vki, vkie = vm3[0], vki3[0], vkie3[0]
            A_vals = C_m * vm + (pde_theta * dt) * vki
            B_vals = C_m * vm - ((1.0 - pde_theta) * dt) * vki
            if tr3.shape[-1] > 0:
                tr, tc = tr3[0], tc3[0]
                tail_A = (tr, tc, C_m * tvm3[0] + (pde_theta * dt) * tvi3[0])
                tail_B = (tr, tc, C_m * tvm3[0] - ((1.0 - pde_theta) * dt) * tvi3[0])
                tail_ki = (tr, tc, tvi3[0])
                tail_kie = (tr, tc, tvie3[0])
            else:
                tail_A = tail_B = tail_ki = tail_kie = None
            diag_v = diag_of(A_vals, cols_loc, tail_A)
            diag_kie = diag_of(vkie, cols_loc, tail_kie)
            diag_kie = jnp.where(diag_kie != 0.0, diag_kie, 1.0)

            kie_mv = lambda x: spmv(vkie, cols_loc, x, tail_kie)  # noqa: E731

            def u_vcycle(r_loc):
                """z ~= K_ie^{-1} r: sharded level-0 Chebyshev + one psum
                restriction + replicated coarse hierarchy."""
                if amg_mode == "dense":
                    r_full = jax.lax.all_gather(r_loc, axis, tiled=True)
                    z_full = jnp.matmul(
                        subh.coarse_inv, r_full[:n_real], precision=jax.lax.Precision.HIGHEST
                    )
                    z_pad = jnp.zeros((part.n_pad,), dtype=r_loc.dtype)
                    z_pad = z_pad.at[:n_real].set(z_full)
                    idx = jax.lax.axis_index(axis)
                    return jax.lax.dynamic_slice(z_pad, (idx * n_local,), (n_local,))
                x = chebyshev_smooth(
                    kie_mv, dinv03[0], lmax0_, r_loc, None, degree, lmin_frac
                )
                resid = r_loc - kie_mv(x)
                # partial coarse product over owned fine nodes, one psum
                rc = jax.lax.psum(
                    jnp.sum(Rv3[0] * resid[Rc3[0]], axis=1), axis
                )
                xc = amg_apply(subh, rc)  # replicated
                x = x + jnp.sum(Pv3[0] * xc[Pc3[0]], axis=1)
                return chebyshev_smooth(
                    kie_mv, dinv03[0], lmax0_, r_loc, x, degree, lmin_frac
                )

            def stim_vector(t):
                b = jnp.zeros((n_local,), dtype=A_vals.dtype)
                for i, (start, dur) in enumerate(windows):
                    on = jnp.where(
                        (t >= start) & (t <= start + dur), amps[win_amp_idx[i]], 0.0
                    )
                    b = b + on * b_units[i]
                for j, (X4, W4, D4, O4) in enumerate(gq):
                    x = jnp.moveaxis(X4[0], -1, 0)
                    vals = gen_exprs[j](x, t) * W4[0]
                    cellvals = jnp.einsum("eq,qd->ed", vals, gen_Ns[j]) * O4[0]
                    load = jnp.zeros((n_local,), dtype=A_vals.dtype)
                    load = load.at[D4[0].ravel()].add(cellvals.ravel())
                    b = b + amps[gen_amp_idx[j]] * load
                return b

            def deflate(x):
                # remove the constant-u_e nullspace component over REAL
                # dofs (pads stay zero); see bidomain.py:one_step
                mask = real_mask(x.dtype)
                return x.at[1].add(-pmean_u(x[1]) * mask)

            def matvec(x):
                x = deflate(x)
                xv, xu = x[0], x[1]
                yv = spmv(A_vals, cols_loc, xv, tail_A) + dt * spmv(
                    vki, cols_loc, xu, tail_ki
                )
                yu = dt * spmv(vki, cols_loc, xv, tail_ki) + (
                    dt / pde_theta
                ) * spmv(vkie, cols_loc, xu, tail_kie)
                return deflate(jnp.stack([yv, yu]))

            if amg_mode == "jacobi":
                def precond(r):
                    zv = r[0] / diag_v
                    zu = r[1] / ((dt / pde_theta) * diag_kie)
                    mask = real_mask(zu.dtype)
                    zu = zu - pmean_u(zu) * mask
                    return jnp.stack([zv, zu])
            else:
                def precond(r):
                    zv = r[0] / diag_v
                    zu = (pde_theta / dt) * u_vcycle(r[1])
                    mask = real_mask(zu.dtype)
                    zu = zu - pmean_u(zu) * mask
                    return jnp.stack([zv, zu])

            def one_step(carry, _):
                states, u_e, t, dvu = carry
                states = ionic(states, t, theta * dt, pnode)
                v = states[v_index]
                ts = t + pde_theta * dt
                rhs_v = (
                    spmv(B_vals, cols_loc, v, tail_B) + dt * stim_vector(ts)
                )
                rhs_u = -(dt / pde_theta) * (1.0 - pde_theta) * spmv(
                    vki, cols_loc, v, tail_ki
                )
                b = jnp.stack([rhs_v, rhs_u])
                mask = real_mask(b.dtype)
                b = b.at[1].add(-pmean_u(b[1]) * mask)
                x0 = jnp.stack([v, u_e]) + dvu
                x0 = x0.at[1].add(-pmean_u(x0[1]) * mask)
                x, info = cg(
                    matvec, b, x0, precond=precond,
                    rtol=rtol, atol=atol, maxiter=maxiter, dot=pdot,
                )
                v_new, u_new = x[0], x[1]
                dvu = x - jnp.stack([v, u_e])
                states = states.at[v_index].set(v_new)
                if not godunov:
                    states = ionic(states, t + theta * dt, (1.0 - theta) * dt, pnode)
                return (states, u_new, t + dt, dvu), (
                    info.iterations, info.residual_norm, info.converged,
                )

            dvu0 = jnp.zeros((2, n_local), dtype=states_loc.dtype)
            (states_loc, u_loc, t, _), (iters, rnorms, convs) = jax.lax.scan(
                one_step, (states_loc, u_loc, t0, dvu0), None, length=n_steps
            )
            # ground the floating extracellular constant to zero real-mean
            u_loc = u_loc - pmean_u(u_loc) * real_mask(u_loc.dtype)
            return (
                states_loc, u_loc, t,
                jax.lax.pmax(jnp.max(iters), axis),
                rnorms[-1],
                jnp.all(convs),
            )

        try:
            from jax import shard_map

            _replication_check = {"check_vma": False}
        except ImportError:  # jax < 0.8
            from jax.experimental.shard_map import shard_map

            _replication_check = {"check_rep": False}

        mesh = self.device_mesh

        def put(x, spec):
            return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

        def put_tree(tree):
            # replicated pytree (coarse hierarchy levels)
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P())),
                tree,
            )

        cols_arg = (
            self._cols if self._cols is not None else np.zeros((nd, 1, 1), dtype=np.int32)
        )
        if self._tails is not None:
            tr3, tc3, tvm3, tvi3, tvie3 = self._tails
        else:
            tr3 = tc3 = np.zeros((nd, 0), dtype=np.int32)
            tvm3 = tvi3 = tvie3 = np.zeros((nd, 0), dtype=npdt)
        pnode_arg = (
            self._params_j if params_sharded else np.zeros((0,), dtype=npdt)
        )
        self._operands = (
            put(cols_arg, P(axis, None, None)),
            put(self._vals_mass, P(axis, None, None)),
            put(self._vals_ki, P(axis, None, None)),
            put(self._vals_kie, P(axis, None, None)),
            put(tr3, P(axis, None)),
            put(tc3, P(axis, None)),
            put(tvm3, P(axis, None)),
            put(tvi3, P(axis, None)),
            put(tvie3, P(axis, None)),
            put(R_cols3, P(axis, None, None)),
            put(R_vals3, P(axis, None, None)),
            put(P_cols3, P(axis, None, None)),
            put(P_vals3, P(axis, None, None)),
            put(dinv0, P(axis, None)),
            put(lmax0, P()),
            put_tree(sub_hier),
            put(st.b_units, P(None, axis)),
            tuple(
                (
                    put(X4, P(axis, None, None, None)),
                    put(W4, P(axis, None, None)),
                    put(D4, P(axis, None, None)),
                    put(O4, P(axis, None, None)),
                )
                for (X4, W4, D4, O4) in st.gen_tables
            ),
            put(pnode_arg, P(None, axis) if params_sharded else P()),
        )

        @partial(jax.jit, static_argnames=("n_steps",))
        def run_chunk_ops(operands, states, u_e, t0, dt, amps, n_steps):
            (
                cols_arg, vals_mass, vals_ki, vals_kie,
                tr3, tc3, tvm3, tvi3, tvie3,
                Rc3, Rv3, Pc3, Pv3, dinv03, lmax0_, subh,
                b_units, gen_tables, pnode,
            ) = operands
            fn = shard_map(
                partial(local_chunk, n_steps=n_steps),
                mesh=mesh,
                in_specs=(
                    P(None, axis),  # states
                    P(axis),  # u_e
                    P(axis, None, None),  # cols3
                    P(axis, None, None),  # vals mass
                    P(axis, None, None),  # vals k_i
                    P(axis, None, None),  # vals k_ie
                    P(axis, None),  # tail rows
                    P(axis, None),  # tail cols
                    P(axis, None),  # tail vals mass
                    P(axis, None),  # tail vals k_i
                    P(axis, None),  # tail vals k_ie
                    P(axis, None, None),  # R cols (column-sliced)
                    P(axis, None, None),  # R vals
                    P(axis, None, None),  # P cols (row-sliced)
                    P(axis, None, None),  # P vals
                    P(axis, None),  # level-0 dinv
                    P(),  # level-0 lmax
                    P(),  # replicated coarse hierarchy (pytree prefix)
                    P(None, axis),  # stimulus unit vectors
                    tuple(
                        (
                            P(axis, None, None, None),
                            P(axis, None, None),
                            P(axis, None, None),
                            P(axis, None, None),
                        )
                        for _ in st.gen_tables
                    ),
                    # node-aligned ODE params (multi-marker masks) or a
                    # replicated empty placeholder
                    P(None, axis) if params_sharded else P(),
                    P(),  # t0
                    P(),  # dt
                    P(),  # amps
                ),
                out_specs=(P(None, axis), P(axis), P(), P(), P(), P()),
                **_replication_check,
            )
            return fn(states, u_e, cols_arg, vals_mass, vals_ki, vals_kie,
                      tr3, tc3, tvm3, tvi3, tvie3,
                      Rc3, Rv3, Pc3, Pv3, dinv03, lmax0_, subh,
                      b_units, gen_tables, pnode, t0, dt, amps)

        self._run_chunk = lambda *a: run_chunk_ops(self._operands, *a)
        self._run_chunk_ops = run_chunk_ops

    # ------------------------------------------------------------------
    @property
    def v(self) -> jnp.ndarray:
        """Transmembrane voltage in the mesh's original dof order."""
        v = self.states[self.v_index][: self.part.n_global]
        if self._iperm is not None:
            v = v[self._iperm]
        return v

    @property
    def u_e(self) -> jnp.ndarray:
        """Extracellular potential in the mesh's original dof order."""
        u = self.u_e_padded[: self.part.n_global]
        if self._iperm is not None:
            u = u[self._iperm]
        return u

    def stimulus_amplitudes(self) -> jnp.ndarray:
        return self._st.amplitudes(self.dtype)

    def solve(
        self,
        interval: tuple[float, float],
        dt: float,
        save_freq: int | None = None,
        save_callback: Callable | None = None,
    ) -> Status:
        """March (T0, T] in fused sharded chunks; ``save_callback(t, v,
        u_e)`` receives host copies (original dof order) at chunk
        boundaries."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        # scalars replicated over the mesh, as the chunk returns its time:
        # every chunk then meets the inputs the first one compiled for
        replicated = NamedSharding(self.device_mesh, P())
        t = jax.device_put(jnp.asarray(T0, dtype=self.dtype), replicated)
        dtj = jax.device_put(jnp.asarray(dt, dtype=self.dtype), replicated)
        done = 0
        ok = True
        while done < n_total:
            n = min(chunk, n_total - done)
            with self.monitor.track_time("sharded_chunk"):
                (
                    self.states, self.u_e_padded, t, it_max, rnorm, conv,
                ) = self._run_chunk(
                    self.states, self.u_e_padded, t, dtj,
                    jax.device_put(self.stimulus_amplitudes(), replicated), n,
                )
                self.states.block_until_ready()
            done += n
            ok = ok and bool(conv)
            self.monitor.record_ksp(
                CGInfo(
                    iterations=int(it_max),
                    residual_norm=float(rnorm),
                    converged=bool(conv),
                )
            )
            if save_callback is not None:
                save_callback(float(t), np.asarray(self.v), np.asarray(self.u_e))
        return Status.OK if ok else Status.NOT_CONVERGING
