"""Sharded fused monodomain solver: shard_map + ppermute halos + psum CG.

Multi-device counterpart of :class:`~fenicsx_beat_tpu.fused.
FusedMonodomainSolver`, replacing the reference's MPI stack:

| reference (MPI/PETSc)                      | here (XLA collectives)        |
|--------------------------------------------|-------------------------------|
| ghostUpdate ADD/REVERSE after RHS assembly | (none needed: RHS is SpMV +   |
| (``base_model.py:203-206``)                |  separable stimulus vector)   |
| scatter_forward after KSP solve            | ppermute halo exchange before |
| (``base_model.py:241-242``)                |  each SpMV                    |
| KSP inner-product allreduce per iteration  | ``lax.psum`` inside CG        |

The whole chunk (scan over steps, CG while_loop, halo ppermutes) is ONE
jitted shard_map program — XLA overlaps the neighbor exchange with local
compute on ICI.
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
from ..base_model import Status, _as_expr, _transform_I_s
from ..config import default_dtype
from ..conductivities import as_cell_tensors
from ..mesh import Mesh
from ..ops.cg import CGInfo, cg
from ..stimulation import TimeWindow, dx as dx_measure
from ..telemetry import BaseMonitor, NullMonitor
from .partition import Partition1D, pad_global, partition_ell, partition_quadrature


__all__ = ["ShardedMonodomainSolver", "PartitionedStimuli", "partition_stimuli"]


@dataclass
class PartitionedStimuli:
    """Stimulus data laid out for the 1-D node partition (separable
    TimeWindow unit vectors + per-device quadrature tables for general
    space-time expressions); shared by the sharded monodomain and
    bidomain solvers."""

    stimuli: list  # amps-slot-aligned: Stimulus or None (general exprs)
    b_units: np.ndarray  # [n_separable, n_pad]
    windows: list
    win_amp_idx: list
    gen_tables: tuple
    gen_Ns: list
    gen_exprs: list
    gen_amp_idx: list

    def amplitudes(self, dtype) -> jnp.ndarray:
        """Live amplitude vector (read each chunk; 1.0 for non-TimeWindow
        exprs whose value is baked into the traced callable)."""
        amps = [
            float(s.expr.amplitude) if s is not None else 1.0 for s in self.stimuli
        ]
        return jnp.asarray(amps or [0.0], dtype=dtype)


def ell_adjacency(mass) -> tuple[np.ndarray, np.ndarray]:
    """CSR adjacency ``(indptr, cols)`` straight from a padded-ELL
    structure, for RCM reordering (pad entries repeat the row index —
    harmless self-loops for RCM; tail-spilled apex edges are omitted,
    which only perturbs the heuristic ordering near the apex — the
    partition halo bound still verifies the result)."""
    n = mass.shape[0]
    mcols = np.asarray(mass.cols)
    rowids = np.broadcast_to(np.arange(n, dtype=mcols.dtype)[:, None], mcols.shape)
    live = np.count_nonzero(mcols != rowids, axis=1) + 1
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(live, out=indptr[1:])
    keep = (mcols != rowids).ravel()
    diag = np.arange(n, dtype=np.int32)
    ucols = np.empty(int(indptr[-1]), dtype=np.int32)
    # per-row: own index first, then the off-diagonal columns
    ucols[indptr[:-1]] = diag
    fill = np.ones(int(indptr[-1]), dtype=bool)
    fill[indptr[:-1]] = False
    ucols[fill] = mcols.ravel()[keep].astype(np.int32)
    return indptr, ucols


def partition_stimuli(
    V, mesh: Mesh, I_s, part: Partition1D, perm, iperm, dtype
) -> PartitionedStimuli:
    """Normalize + partition stimuli: TimeWindow protocols stay separable
    (b(t) = sum_s window_s(t) * b_s, one precomputed unit vector each);
    everything else gets per-device quadrature tables and is assembled
    inside the sharded step at the traced time t (the reference assembles
    these over each MPI rank's cells via DOLFINx)."""
    from ..stimulation import separable_stimulus_terms

    stimuli = _transform_I_s(I_s, dZ=dx_measure(mesh))
    stim_quads = []
    for s in stimuli:
        ents = s.dz.entities()
        if len(ents) == 0:
            continue
        if s.dz.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=4, dtype=dtype)
        else:
            quad = fem.facet_quadrature(V, ents, degree=4, dtype=dtype)
        if isinstance(s.expr, TimeWindow):
            stim_quads.append((quad, s.expr.indicator, s))
        else:
            stim_quads.append((quad, _as_expr(s.expr), None))
    terms, b_units_host = separable_stimulus_terms(stim_quads)
    b_units, windows, win_amp_idx = [], [], []
    gen_tables, gen_exprs, gen_Ns, gen_amp_idx = [], [], [], []
    for slot, quad, expr, b_idx, window in terms:
        if b_idx is not None:
            b_unit = b_units_host[b_idx]
            if perm is not None:
                b_unit = b_unit[perm]
            b_units.append(pad_global(b_unit, part))
            windows.append(window)
            win_amp_idx.append(slot)
        else:
            X3, W3, N, D3, O3 = partition_quadrature(quad, part, iperm)
            gen_tables.append((X3, W3, D3, O3))
            gen_Ns.append(N)
            gen_exprs.append(expr)
            gen_amp_idx.append(slot)
    npdt = np.dtype(jnp.dtype(dtype).name)
    return PartitionedStimuli(
        stimuli=[sq[2] for sq in stim_quads],
        b_units=(
            np.stack(b_units).astype(npdt)
            if b_units
            else np.zeros((0, part.n_pad), dtype=npdt)
        ),
        windows=windows,
        win_amp_idx=win_amp_idx,
        gen_tables=tuple(gen_tables),
        gen_Ns=gen_Ns,
        gen_exprs=gen_exprs,
        gen_amp_idx=gen_amp_idx,
    )


@dataclass
class ShardedMonodomainSolver:
    """Monodomain splitting solver sharded over a 1-D device mesh.

    Node arrays (ionic states, voltage, activation) are sharded along the
    node axis; each device owns a contiguous block.  Structured slabs keep
    their lexicographic order (stencil SpMV); unstructured meshes (LV
    ellipsoid, BiV) are RCM-renumbered at setup so the block partition has
    a bounded halo, with spilled high-degree rows (hybrid ELL+tail) carried
    as a per-device COO tail — the in-repo counterpart of the reference's
    DOLFINx/MPI mesh partitioning (``geometry.py:112-139`` there).  Outputs
    (``v``, ``activation_times``) are returned in the mesh's original dof
    order.  ``TimeWindow`` stimuli use a precomputed separable fast path;
    arbitrary space-time callables are assembled per device inside the
    step.  Multi-marker ionic models (dict-valued ``ode_fun`` /
    ``init_states`` / ``parameters`` / ``v_index`` plus ``ode_markers``)
    follow ``DolfinMultiODESolver`` semantics via masked composition
    (:func:`~fenicsx_beat_tpu.odesolver.make_multi_ode`).
    """

    mesh: Mesh
    M: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    device_mesh: DeviceMesh
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0  # splitting scheme
    pde_theta: float = 0.5  # PDE time discretization (reference CN default)
    C_m: float = 1.0
    cg_rtol: float = 1e-8
    cg_atol: float = 1e-10
    cg_maxiter: int = 1000
    activation_threshold: float = 0.0
    dtype: Any = None
    monitor: BaseMonitor = field(default_factory=NullMonitor)
    ode_markers: Any = None  # per-node marker array/Function: multi-model
    operator_cache_key: str | None = None  # opt-in disk cache of assembly
    # ionic step route (ops/ionic_kernel.select_route): None = the Pallas
    # kernel on each GPU shard when the model qualifies, XLA otherwise;
    # "xla" forces the jnp model, "interpret" runs the kernel in the
    # Pallas interpreter (CPU tests)
    ionic_kernel: str | None = None

    def __post_init__(self):
        self.dtype = self.dtype or default_dtype()
        (self.axis,) = self.device_mesh.axis_names
        nd = self.device_mesh.devices.size

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self.V.ndofs

        # multi-marker ionic models: compose into one traceable step whose
        # `parameters` are the node masks (sharded along the node axis)
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
            if markers.shape[0] != n:
                raise ValueError(
                    f"ode_markers has {markers.shape[0]} entries, expected {n}"
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

        M_cells = as_cell_tensors(self.M, self.mesh)
        from ..ops.sparse import coo_to_ell, ell_to_stencil
        from .partition import partition_stencil

        # Node renumbering (perm[new] = old): identity on structured slabs
        # (lexicographic order is already banded); RCM on unstructured
        # meshes so the 1-D block partition has a bounded halo.  This is
        # the role the DOLFINx/MPI partitioner plays for the reference
        # (``geometry.py:112-139`` there).
        self._perm = None
        self._iperm = None

        # Direct stencil assembly first (fused.py:132-144): on structured
        # meshes this skips the COO pipeline entirely — the generic path
        # needs >30 min of host time at the 20M-cell dx=0.05 resolution,
        # which would make production-scale sharding setup-bound.
        st = fem.assemble_mass_stiffness_stencil(
            self.V, M_cells, dtype=self.dtype, cache_key=self.operator_cache_key
        )
        rows = None  # COO triplets, built only on the fallback path
        if st is not None:
            mass_st, stiff_st = st
        else:
            pair = fem._assemble_mass_stiffness_ell_direct(self.V, M_cells, self.dtype)
            if pair is not None:
                # width-bounded direct assembly: no [n, max_degree] tables
                # (the LV apex degree grows with resolution and made the
                # 4x coo_to_ell conversions here superlinear — 338 s at
                # 243k nodes)
                mass, stiff = pair
            else:
                rows, cols, mvals, kvals, shape = fem.assemble_mass_stiffness_coo(
                    self.V, M_cells
                )
                mass = coo_to_ell(rows, cols, mvals, shape, dtype=self.dtype)
                stiff = coo_to_ell(rows, cols, kvals, shape, dtype=self.dtype)
            # stencil (fixed-offset) partition: gather-free shifted-FMA SpMV
            # on the extended local vector; falls back to hybrid ELL
            mass_st = ell_to_stencil(mass)
            stiff_st = ell_to_stencil(stiff) if mass_st is not None else None
            if stiff_st is not None and stiff_st.offsets != mass_st.offsets:
                mass_st = stiff_st = None

        if stiff_st is not None:
            part_m, vals_mass = partition_stencil(mass_st, nd, diag_pad=1.0)
            part_k, vals_stiff = partition_stencil(stiff_st, nd, diag_pad=0.0)
            assert part_m == part_k
            self._offsets = mass_st.offsets
            self._cols = None
            self._tail = None
        else:
            from ..native import rcm_ordering

            if rows is not None:
                # symmetric pattern => CSR adjacency from the deduped triplets
                key = rows.astype(np.int64) * n + cols.astype(np.int64)
                uniq = np.unique(key)
                urows = (uniq // n).astype(np.int64)
                ucols = (uniq % n).astype(np.int32)
                indptr = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(np.bincount(urows, minlength=n), out=indptr[1:])
            else:
                indptr, ucols = ell_adjacency(mass)
            perm = rcm_ordering(indptr, ucols).astype(np.int64)
            iperm = np.empty(n, dtype=np.int64)
            iperm[perm] = np.arange(n, dtype=np.int64)
            self._perm = perm
            self._iperm = iperm
            if rows is not None:
                mass = coo_to_ell(iperm[rows], iperm[cols], mvals, shape, dtype=self.dtype)
                stiff = coo_to_ell(iperm[rows], iperm[cols], kvals, shape, dtype=self.dtype)
            else:
                # re-assemble on the RCM-renumbered mesh: the direct
                # kernel is cheap enough (3.6 s at 10.6M cells) that a
                # second pass beats permuting [n, W] tables through host
                # memory
                from ..mesh import Mesh as _Mesh

                pm = _Mesh(
                    coords=self.mesh.coords[perm],
                    cells=iperm[self.mesh.cells.astype(np.int64)].astype(np.int32),
                    cell_type=self.mesh.cell_type,
                )
                Vp = fem.functionspace(pm, ("P", 1))
                pair = fem._assemble_mass_stiffness_ell_direct(Vp, M_cells, self.dtype)
                assert pair is not None  # same shapes that succeeded above
                mass, stiff = pair

            part_m, cols_m, vals_mass, tail_m = partition_ell(mass, nd)
            part_k, cols_k, vals_stiff, tail_k = partition_ell(stiff, nd)
            # identical sparsity pattern => identical partition geometry
            assert part_m == part_k and bool(jnp.all(cols_m == cols_k))
            self._offsets = None
            self._cols = cols_m
            if tail_m is not None:
                tr, tc, tvm = tail_m
                _, _, tvk = tail_k
                self._tail = (tr, tc, tvm, tvk)
            else:
                self._tail = None
        self.part: Partition1D = part_m
        self._vals_mass = vals_mass
        self._vals_stiff = vals_stiff

        st_part = partition_stimuli(
            self.V, self.mesh, self.I_s, self.part, self._perm, self._iperm, self.dtype
        )
        # amps-slot-aligned: Stimulus or None (general)
        self._stimuli = st_part.stimuli
        self._b_units = st_part.b_units
        self._windows = st_part.windows
        self._win_amp_idx = st_part.win_amp_idx
        self._gen_tables = st_part.gen_tables
        self._gen_Ns = st_part.gen_Ns
        self._gen_exprs = st_part.gen_exprs
        self._gen_amp_idx = st_part.gen_amp_idx
        npdt = np.dtype(jnp.dtype(self.dtype).name)

        init = np.asarray(self.init_states, dtype=np.float64)
        if init.ndim == 1:
            states = np.tile(init[:, None], (1, n))
        else:
            states = init.copy()
            if self._perm is not None:
                states = states[:, self._perm]
        pad = self.part.n_pad - n
        if pad:
            # replicate node 0 into the padding so log/division-based ionic
            # models stay finite on the fictitious dofs (zero-filled
            # concentrations would produce NaNs that poison the unmasked
            # CG reductions)
            states = np.concatenate([states, np.tile(states[:, :1], (1, pad))], axis=1)
        act = np.full(self.part.n_pad, -1.0)

        shard_nodes = NamedSharding(self.device_mesh, P(None, self.axis))
        shard_vec = NamedSharding(self.device_mesh, P(self.axis))
        self.states = jax.device_put(jnp.asarray(states, dtype=self.dtype), shard_nodes)
        self.activation_time = jax.device_put(jnp.asarray(act, dtype=self.dtype), shard_vec)
        # ODE parameters: node-aligned arrays (multi-marker masks, per-node
        # parameter vectors) are permuted/padded and threaded through
        # shard_map along the node axis; plain vectors replicate via closure
        self._params_sharded = False
        if self._ode_masks is not None:
            masks = self._ode_masks
            if self._perm is not None:
                masks = masks[:, self._perm]
            if pad:
                masks = np.concatenate([masks, np.tile(masks[:, :1], (1, pad))], axis=1)
            self._params_j = np.asarray(masks)
            self._params_sharded = True
        elif self.parameters is not None and np.ndim(self.parameters) == 2:
            pvals = np.asarray(self.parameters, dtype=np.float64)
            if self._perm is not None:
                pvals = pvals[:, self._perm]
            if pad:
                pvals = np.concatenate([pvals, np.tile(pvals[:, :1], (1, pad))], axis=1)
            self._params_j = pvals.astype(npdt)
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
        C_m = float(self.C_m)
        thr = float(self.activation_threshold)
        v_index = self.v_index
        ode_fun = self.ode_fun
        params_j = self._params_j
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
        windows = self._windows
        win_amp_idx = self._win_amp_idx
        gen_Ns = self._gen_Ns
        gen_exprs = self._gen_exprs
        gen_amp_idx = self._gen_amp_idx
        rtol, atol, maxiter = self.cg_rtol, self.cg_atol, self.cg_maxiter
        fwd = [(i, i + 1) for i in range(nd - 1)]
        bwd = [(i + 1, i) for i in range(nd - 1)]

        def halo_extend(x_loc):
            """[n_local] -> [n_local + 2H] with neighbor halos (ppermute)."""
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
                # cols_loc unused: shifted fused multiply-adds over the
                # extended local vector (same trick as StencilMatrix)
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
                    # hybrid COO tail (spilled high-degree rows, e.g. the
                    # welded LV apex): scatter-add against the extended
                    # local vector; pad slots carry value 0
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

        # per-device mask excluding the globally padded dofs from CG inner
        # products (same reasoning as the fused solver's masked cg_dot)
        n_real = part.n_global
        dev_starts = np.arange(nd) * n_local
        real_per_dev = np.clip(n_real - dev_starts, 0, n_local)

        def pdot(a, b):
            idx = jax.lax.axis_index(axis)
            k = jnp.asarray(real_per_dev)[idx]
            mask = (jnp.arange(n_local) < k).astype(a.dtype)
            return jax.lax.psum(jnp.vdot(a * mask, b), axis)

        def local_chunk(
            states_loc, act_loc, cols3, vm3, vk3, tr3, tc3, tvm3, tvk3,
            b_units, gq, pnode, t0, dt, amps, n_steps,
        ):
            cols_loc = cols3[0]
            vm = vm3[0]
            vk = vk3[0]
            A_vals = C_m * vm + (pde_theta * dt) * vk
            B_vals = C_m * vm - ((1.0 - pde_theta) * dt) * vk
            if tr3.shape[-1] > 0:
                tr, tc = tr3[0], tc3[0]
                tail_A = (tr, tc, C_m * tvm3[0] + (pde_theta * dt) * tvk3[0])
                tail_B = (tr, tc, C_m * tvm3[0] - ((1.0 - pde_theta) * dt) * tvk3[0])
            else:
                tail_A = tail_B = None
            diag = diag_of(A_vals, cols_loc, tail_A)

            def stim_vector(t):
                # amplitudes are traced so Stimulus.assign takes effect at
                # the next chunk (matches the fused solver)
                b = jnp.zeros((n_local,), dtype=A_vals.dtype)
                for i, (start, dur) in enumerate(windows):
                    on = jnp.where(
                        (t >= start) & (t <= start + dur), amps[win_amp_idx[i]], 0.0
                    )
                    b = b + on * b_units[i]
                # non-separable stimuli: per-device quadrature assembly at
                # the traced time (fused path: _assemble_rhs)
                for j, (X4, W4, D4, O4) in enumerate(gq):
                    x = jnp.moveaxis(X4[0], -1, 0)
                    vals = gen_exprs[j](x, t) * W4[0]
                    cellvals = jnp.einsum("eq,qd->ed", vals, gen_Ns[j]) * O4[0]
                    load = jnp.zeros((n_local,), dtype=A_vals.dtype)
                    load = load.at[D4[0].ravel()].add(cellvals.ravel())
                    b = b + amps[gen_amp_idx[j]] * load
                return b

            def one_step(carry, _):
                states, act, t, dv = carry
                states = ionic(states, t, theta * dt, pnode)
                v = states[v_index]
                b = spmv(B_vals, cols_loc, v, tail_B) + dt * stim_vector(t + pde_theta * dt)
                # warm start with the previous solve increment (matches the
                # fused solver)
                v_new, info = cg(
                    lambda u: spmv(A_vals, cols_loc, u, tail_A),
                    b,
                    v + dv,
                    precond_diag=diag,
                    rtol=rtol,
                    atol=atol,
                    maxiter=maxiter,
                    dot=pdot,
                )
                dv = v_new - v
                states = states.at[v_index].set(v_new)
                if not np.isclose(theta, 1.0):
                    states = ionic(states, t + theta * dt, (1.0 - theta) * dt, pnode)
                    v_new = states[v_index]
                act = jnp.where((v_new > thr) & (act < 0), t, act)
                return (states, act, t + dt, dv), (
                    info.iterations,
                    info.residual_norm,
                    info.converged,
                )

            dv0 = jnp.zeros_like(states_loc[v_index])
            (states_loc, act_loc, t, _), (iters, rnorms, convs) = jax.lax.scan(
                one_step, (states_loc, act_loc, t0, dv0), None, length=n_steps
            )
            # residuals/flags come from psum'd dots, so they are already
            # replicated; pmax keeps the iteration count collective-consistent
            return (
                states_loc,
                act_loc,
                t,
                jax.lax.pmax(jnp.max(iters), axis),
                rnorms[-1],
                jnp.all(convs),
            )

        try:
            from jax import shard_map

            _replication_check = {"check_vma": False}
        except ImportError:  # jax < 0.8: same API but the kwarg is check_rep
            from jax.experimental.shard_map import shard_map

            _replication_check = {"check_rep": False}

        mesh = self.device_mesh

        # Device-resident operands pushed ONCE with their final shardings
        # and threaded through the jitted chunk as ARGUMENTS (no large
        # constants in the compiled program).
        def put(x, spec):
            # device_put directly from the host array: splits on host and
            # ships each shard once (jnp.asarray first would transfer the
            # whole array to device 0 and then redistribute)
            return jax.device_put(np.asarray(x), NamedSharding(mesh, spec))

        cols_arg = (
            self._cols
            if self._cols is not None
            else np.zeros((nd, 1, 1), dtype=np.int32)
        )
        vals_mass_arg, vals_stiff_arg = self._vals_mass, self._vals_stiff
        if self._tail is not None:
            tr3, tc3, tvm3, tvk3 = self._tail
        else:
            tr3 = tc3 = np.zeros((nd, 0), dtype=np.int32)
            tvm3 = tvk3 = np.zeros((nd, 0), dtype=np.asarray(self._vals_mass).dtype)
        cols_spec = P(axis, None, None)
        vals_spec = P(axis, None, None)
        pnode_arg = (
            self._params_j
            if params_sharded
            else np.zeros((0,), dtype=np.dtype(jnp.dtype(self.dtype).name))
        )
        self._operands = (
            put(cols_arg, cols_spec),
            put(vals_mass_arg, vals_spec),
            put(vals_stiff_arg, vals_spec),
            put(tr3, P(axis, None)),
            put(tc3, P(axis, None)),
            put(tvm3, P(axis, None)),
            put(tvk3, P(axis, None)),
            put(self._b_units, P(None, axis)),
            tuple(
                (
                    put(X4, P(axis, None, None, None)),
                    put(W4, P(axis, None, None)),
                    put(D4, P(axis, None, None)),
                    put(O4, P(axis, None, None)),
                )
                for (X4, W4, D4, O4) in self._gen_tables
            ),
            put(pnode_arg, P(None, axis) if params_sharded else P()),
        )

        @partial(jax.jit, static_argnames=("n_steps",))
        def run_chunk_ops(operands, states, act, t0, dt, amps, n_steps):
            (
                cols_arg,
                vals_mass,
                vals_stiff,
                tr3,
                tc3,
                tvm3,
                tvk3,
                b_units,
                gen_tables,
                pnode_arg,
            ) = operands
            fn = shard_map(
                partial(local_chunk, n_steps=n_steps),
                mesh=mesh,
                in_specs=(
                    P(None, axis),  # states
                    P(axis),  # activation
                    cols_spec,  # cols3 (ELL)
                    vals_spec,  # vals mass
                    vals_spec,  # vals stiff
                    P(axis, None),  # tail rows (local)
                    P(axis, None),  # tail cols (extended local)
                    P(axis, None),  # tail vals mass
                    P(axis, None),  # tail vals stiffness
                    P(None, axis),  # stimulus unit vectors
                    tuple(
                        (
                            P(axis, None, None, None),  # quad points X
                            P(axis, None, None),  # quad weights W
                            P(axis, None, None),  # local target dofs
                            P(axis, None, None),  # ownership mask
                        )
                        for _ in self._gen_tables
                    ),  # non-separable stimulus tables
                    # node-aligned ODE parameters (multi-marker masks /
                    # per-node vectors) shard along nodes; otherwise a
                    # dummy replicated placeholder (closure carries them)
                    P(None, axis) if params_sharded else P(),
                    P(),  # t0
                    P(),  # dt
                    P(),  # stimulus amplitudes (traced: assign support)
                ),
                out_specs=(P(None, axis), P(axis), P(), P(), P(), P()),
                **_replication_check,
            )
            return fn(states, act, cols_arg, vals_mass, vals_stiff,
                      tr3, tc3, tvm3, tvk3, b_units, gen_tables,
                      pnode_arg, t0, dt, amps)

        def run_chunk(states, act, t0, dt, amps, n_steps):
            return run_chunk_ops(self._operands, states, act, t0, dt, amps, n_steps)

        self._run_chunk = run_chunk
        self._run_chunk_ops = run_chunk_ops

    def stimulus_amplitudes(self) -> jnp.ndarray:
        """Live amplitude vector (read each chunk; 1.0 for non-TimeWindow
        exprs whose value is baked into the traced callable)."""
        amps = [
            float(s.expr.amplitude) if s is not None else 1.0 for s in self._stimuli
        ]
        return jnp.asarray(amps or [0.0], dtype=self.dtype)

    # ------------------------------------------------------------------
    @property
    def v(self) -> jnp.ndarray:
        """Voltage in the mesh's original dof order."""
        v = self.states[self.v_index][: self.part.n_global]
        if self._iperm is not None:
            v = v[self._iperm]
        return v

    def solve(self, interval, dt, save_freq: int | None = None, save_callback=None) -> Status:
        """Sharded time loop; returns ``Status.NOT_CONVERGING`` if any
        step's CG hit ``cg_maxiter`` without meeting tolerance."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        # scalars replicated over the mesh, as the chunk returns its time:
        # every chunk then meets the inputs the first one compiled for
        replicated = NamedSharding(self.device_mesh, P())
        t = jax.device_put(jnp.asarray(T0, dtype=self.dtype), replicated)
        dtj = jax.device_put(jnp.asarray(dt, dtype=self.dtype), replicated)
        done = 0
        all_converged = True
        while done < n_total:
            n = min(chunk, n_total - done)
            with self.monitor.track_time("sharded_chunk"):
                (
                    self.states,
                    self.activation_time,
                    t,
                    it_max,
                    rnorm,
                    conv,
                ) = self._run_chunk(
                    self.states,
                    self.activation_time,
                    t,
                    dtj,
                    jax.device_put(self.stimulus_amplitudes(), replicated),
                    n,
                )
                self.states.block_until_ready()
            done += n
            converged = bool(conv)
            all_converged &= converged
            self.monitor.record_ksp(
                CGInfo(
                    iterations=int(it_max),
                    residual_norm=float(rnorm),
                    converged=converged,
                )
            )
            self.monitor.advance_step(float(t) - n * dt, float(t))
            if save_callback is not None:
                save_callback(float(t), np.asarray(self.v))
        self.last_solve_converged = all_converged
        return Status.OK if all_converged else Status.NOT_CONVERGING

    def activation_times(self) -> np.ndarray:
        """Activation times in the mesh's original dof order."""
        act = np.asarray(self.activation_time)[: self.part.n_global]
        if self._iperm is not None:
            act = act[self._iperm]
        return act

    # ------------------------------------------------------------------
    # full-state checkpoint / resume (parity with FusedMonodomainSolver;
    # arrays are stored in the mesh's ORIGINAL dof order so a checkpoint
    # is portable across device counts and renumberings)
    def save_state(self, path, t: float = 0.0):
        from pathlib import Path

        n = self.part.n_global
        states = np.asarray(self.states)[:, :n]
        act = np.asarray(self.activation_time)[:n]
        if self._iperm is not None:
            states = states[:, self._iperm]
            act = act[self._iperm]
        out = Path(path).with_suffix(".npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out,
            states=states,
            activation_time=act,
            t=float(t),
            v_index=self.v_index,
        )
        return out

    def load_state(self, path) -> float:
        from pathlib import Path

        from jax.sharding import NamedSharding, PartitionSpec as P

        with np.load(Path(path).with_suffix(".npz")) as f:
            states = f["states"]
            act = f["activation_time"]
            t = float(f["t"])
            ck_vi = int(f["v_index"])
        n = self.part.n_global
        if states.shape[1] != n:
            raise ValueError(f"checkpoint has {states.shape[1]} nodes, mesh has {n}")
        if states.shape[0] != self.states.shape[0]:
            raise ValueError(
                f"checkpoint has {states.shape[0]} ionic states, solver has "
                f"{self.states.shape[0]} (different model?)"
            )
        if ck_vi != int(self.v_index):
            raise ValueError(
                f"checkpoint v_index {ck_vi} != solver {self.v_index} "
                "(different ionic model?)"
            )
        if self._perm is not None:
            states = states[:, self._perm]
            act = act[self._perm]
        pad = self.part.n_pad - n
        if pad:
            states = np.concatenate([states, np.tile(states[:, :1], (1, pad))], axis=1)
            act = np.concatenate([act, np.full(pad, -1.0)])
        shard_nodes = NamedSharding(self.device_mesh, P(None, self.axis))
        shard_vec = NamedSharding(self.device_mesh, P(self.axis))
        self.states = jax.device_put(jnp.asarray(states, dtype=self.dtype), shard_nodes)
        self.activation_time = jax.device_put(jnp.asarray(act, dtype=self.dtype), shard_vec)
        return t
