"""Bidomain cardiac electrophysiology: transmembrane AND extracellular
potentials.

Beyond the reference's scope (fenicsx-beat is monodomain-only — its JOSS
paper and ``src/beat/monodomain_model.py``); the bidomain model is the
physical parent the monodomain reduction comes from, needed whenever the
extracellular field matters (defibrillation shocks, plunge-electrode
potentials, genuinely unequal anisotropy ratios):

.. math::

    C_m \\partial_t v + I_{ion} &= \\nabla\\cdot(M_i \\nabla(v + u_e)) + I_s \\\\
    0 &= \\nabla\\cdot(M_i \\nabla v) + \\nabla\\cdot((M_i + M_e)\\nabla u_e)

Discretization (theta rule on v, same operator conventions as
``base_model.py``: ``K(M)`` is the SPD stiffness of ``-div(M grad)``):

.. math::

    \\begin{bmatrix} C_m M + \\theta\\,dt\\,K_i & dt\\,K_i \\\\
                     dt\\,K_i & (dt/\\theta)(K_i + K_e) \\end{bmatrix}
    \\begin{bmatrix} v' \\\\ u_e \\end{bmatrix} =
    \\begin{bmatrix} (C_m M - (1-\\theta)dt\\,K_i)\\,v + dt\\,b_s \\\\
                     -(dt/\\theta)(1-\\theta)\\,K_i\\,v \\end{bmatrix}

The block operator is symmetric positive semidefinite (nullspace =
constant u_e, to which the right-hand side is automatically orthogonal
because stiffness rows sum to zero), so the SAME Jacobi-PCG the
monodomain solvers use runs on the stacked ``[2, n]`` vector — the
solve is just two extra SpMV streams per CG iteration.  Operator
splitting (Godunov/Strang) and the ionic layer are shared with the
monodomain solvers unchanged.

Verified by exact reduction: with proportional conductivities
``M_e = lam * M_i`` the bidomain ``v`` equals the monodomain solution
with ``M = lam/(1+lam) * M_i`` step for step, and
``u_e = -(theta v' + (1-theta) v)/(1+lam)`` up to its floating constant
(``tests/test_bidomain.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import fem
from .base_model import Status
from .conductivities import as_cell_tensors
from .ops.cg import cg
from .stimulation import separable_stimulus_terms
from .telemetry import BaseMonitor, NullMonitor

__all__ = ["BidomainSolver"]


@dataclass
class BidomainSolver:
    """Operator-splitting bidomain solver (jitted per-chunk ``lax.scan``).

    Same constructor vocabulary as :class:`~fenicsx_beat_tpu.fused.
    FusedMonodomainSolver` plus the second conductivity: ``M_i`` is the
    intracellular tensor (any spec `as_cell_tensors` accepts), ``M_e``
    the extracellular one.  ``theta`` picks the splitting (1 = Godunov,
    0.5 = Strang); ``pde_theta`` the PDE time rule."""

    mesh: Any
    M_i: Any
    M_e: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
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
    # elliptic u_e-block preconditioner: "auto" picks the DCT spectral
    # inverse on constant-coefficient structured grids; elsewhere it
    # picks SA-AMG (the counterpart of the reference's CG + hypre
    # BoomerAMG default, reference src/beat/base_model.py:140-157);
    # "amg"/"dct"/"jacobi" force a specific choice
    u_precond: str = "auto"
    # time-coupling scheme for the (v, u_e) pair:
    #   "monolithic" — one deflated PCG on the symmetric 2x2 block system
    #     per step (4 operator streams per CG iteration).
    #   "gs" — Gauss-Seidel decoupling: implicit parabolic v-solve with
    #     the LAGGED u_e, then the elliptic constraint
    #     ``K_ie u' = -K_i (theta v' + (1-theta) v)`` (exactly the block
    #     system's second row).  Each sub-solve streams ONE combined
    #     operator per CG iteration instead of four, the parabolic block
    #     is mass-dominated (few iterations), and on structured grids
    #     both sub-solves take the DCT model as a near-exact
    #     preconditioner.  First-order lag error in the v<->u_e coupling
    #     (the splitting itself is already O(dt)); equivalence vs
    #     monolithic is gated in tests/test_bidomain.py.
    scheme: str = "monolithic"
    # gs-scheme per-solve relative tolerances (None = cg_rtol).  The
    # elliptic u-solve tolerates looseness: the O(dt^2) extrapolated
    # coupling lag already bounds the step error near 1e-4 relative, so
    # solving u_e tighter than ~1e-4..1e-5 buys nothing the v-field can
    # see (error-gated in tests/test_bidomain.py)
    gs_v_rtol: float | None = None
    gs_u_rtol: float | None = None
    # gs-scheme elliptic cadence: solve the u_e block only on every k-th
    # step; in between, u_e advances by the same O(dt^2) linear
    # extrapolation already used for the coupling lag (the warm-start
    # increment u_e^k - u_e^{k-1}).  The elliptic constraint has no time
    # derivative — u_e is an algebraic function of v — so between solves
    # the extrapolation tracks it to the same order as the gs lag itself.
    # k=2 halves the step's elliptic CG traffic (the dominant cost at
    # the dx=0.1 slab: ~10 of the 14 combined iterations/step are
    # u-solves); error vs k=1 is gated in tests/test_bidomain.py
    u_solve_every: int = 1
    # extra keyword arguments for ops.amg.build_amg (hierarchy depth,
    # smoother degree, coarse size — the knobs the preconditioner
    # experiments sweep); None = build_amg defaults
    u_amg_opts: dict | None = None
    # opt-in disk cache namespace for the expensive host setup products
    # (assembled operators AND the AMG hierarchy) — both are content-
    # fingerprinted, so the string only namespaces; a warm second
    # construction skips minutes of host time on production meshes
    cache_key: str | None = None
    # per-node marker array/Function for dict-valued ode_fun (multi-model
    # tissue, e.g. endo/epi TP06 celltypes — fused.py's contract)
    ode_markers: Any = None
    # ionic step route (ops/ionic_kernel.select_route): None = the Pallas
    # kernel when the state lives on a GPU and the model qualifies, XLA
    # otherwise; "xla" forces the jnp model, "interpret" runs the kernel
    # in the Pallas interpreter (CPU tests)
    ionic_kernel: str | None = None

    def __post_init__(self):
        from .config import default_dtype

        self.dtype = self.dtype or default_dtype()
        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self._n = self.V.ndofs

        if self.scheme not in ("monolithic", "gs"):
            raise ValueError(
                f"scheme must be 'monolithic' or 'gs', got {self.scheme!r}"
            )
        if int(self.u_solve_every) < 1:
            raise ValueError(
                f"u_solve_every must be >= 1, got {self.u_solve_every!r}"
            )
        if int(self.u_solve_every) > 1 and self.scheme != "gs":
            raise ValueError(
                "u_solve_every > 1 requires scheme='gs' (the monolithic "
                "block solve has no separate elliptic sub-solve to skip)"
            )
        if isinstance(self.ode_fun, dict):
            # multi-marker ionic models: compose into one traceable step
            # whose `parameters` are the node masks (fused.py's contract)
            if self.ode_markers is None:
                raise ValueError("dict-valued ode_fun requires ode_markers")
            from .odesolver import make_multi_ode

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
                masks,
                self.v_index,
            ) = make_multi_ode(
                markers,
                self.ode_fun,
                self.init_states,
                self.parameters,
                self.v_index,
                dtype=self.dtype,
            )
            self.parameters = masks  # masks travel as the traced parameters
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"splitting theta must lie in (0, 1], got {self.theta}")
        if not 0.0 < self.pde_theta <= 1.0:
            raise ValueError(f"pde_theta must lie in (0, 1], got {self.pde_theta}")

        Mi = as_cell_tensors(self.M_i, self.mesh)
        Me = as_cell_tensors(self.M_e, self.mesh)
        ck = self.cache_key
        mass, k_i = fem.assemble_mass_stiffness_auto(
            self.V, Mi, dtype=self.dtype,
            cache_key=None if ck is None else ck + "|i",
        )
        # the fused assembly kernels produce mass+stiffness in ONE pass, so
        # the second mass is a by-product, not a second pipeline
        _, k_e = fem.assemble_mass_stiffness_auto(
            self.V, Me, dtype=self.dtype,
            cache_key=None if ck is None else ck + "|e",
        )
        # same mesh + assembler => shared pattern; combine is value-level
        k_ie = k_i.combine(1.0, k_e, 1.0)
        self._mass, self._k_i, self._k_ie = mass, k_i, k_ie

        # dtype-aware solver tolerances (fused.py does the same): the
        # defaults are f64-grade; f32 cannot reach 1e-8
        if jnp.dtype(self.dtype).itemsize == 4:
            self.cg_rtol = max(self.cg_rtol, 1e-6)
            self.cg_atol = max(self.cg_atol, 1e-7)

        # stimulus normalization + quadrature: the shared machinery of the
        # fused/OO solvers (callables/scalars wrap into Stimulus there)
        from .base_model import _transform_I_s
        from .stimulation import dx as dx_measure
        from .stimulation import stimulus_quadratures

        stimuli = _transform_I_s(self.I_s, dx_measure(self.mesh))
        self._stim_quads = stimulus_quadratures(
            self.V, stimuli, degree=4, dtype=self.dtype
        )
        terms, b_units = separable_stimulus_terms(self._stim_quads)
        self._stim_terms = terms
        self._b_units = [jnp.asarray(np.asarray(b), dtype=self.dtype) for b in b_units]

        init = np.asarray(self.init_states, dtype=np.float64)
        states = np.tile(init[:, None], (1, n)) if init.ndim == 1 else init
        self.states = jnp.asarray(states, dtype=self.dtype)
        self.u_e = jnp.zeros((n,), dtype=self.dtype)
        npdt = np.dtype(jnp.dtype(self.dtype).name)
        self._params = (
            None
            if self.parameters is None
            else np.asarray(self.parameters, dtype=np.float64).astype(npdt)
        )
        self._build_step()

    # ------------------------------------------------------------------
    def _build_step(self):
        # spectral (DCT) preconditioner for the elliptic u_e block on
        # structured grids with constant coefficients: collapses the
        # O(1/h) Jacobi-CG iteration growth to near-O(1)
        # (ops/spectral.py; docs/DESIGN.md §6b); heterogeneous and
        # unstructured cases use SA-AMG (below)
        from .ops.amg import amg_apply, build_amg
        from .ops.spectral import dct_solve, stencil_dct_eigenvalues

        if self.u_precond not in ("auto", "dct", "amg", "jacobi"):
            raise ValueError(
                f"u_precond must be auto/dct/amg/jacobi, got {self.u_precond!r}"
            )
        spec = None
        if hasattr(self._k_ie, "offsets") and self.u_precond in ("auto", "dct"):
            spec = stencil_dct_eigenvalues(self._k_ie, self.mesh, dtype=self.dtype)
        if spec is None and self.u_precond == "dct":
            raise ValueError(
                "u_precond='dct' requires a constant-coefficient structured "
                "grid (stencil operator with constant interior rows)"
            )
        hier = None
        # smoothed-aggregation AMG wherever the DCT declines under 'auto':
        # the elliptic block is pure stiffness, iteration-bound under
        # Jacobi (O(1/h) growth, docs/DESIGN.md §6b); the hierarchy is
        # semidefinite-aware (nullspace = constant u_e)
        want_amg = self.u_precond == "amg" or (
            spec is None and self.u_precond == "auto"
        )
        if spec is None and want_amg:
            # defaults measured at the 79k/244k LV: fiber-semicoarsening
            # strength on the fine level, standard below; UNSMOOTHED
            # (1-plane) transfers everywhere — cheaper AND better
            # convergence than smoothed on the anisotropic operator
            # (16-21 its vs 31 smoothed vs 125 Jacobi at 79k, f64 rtol
            # 1e-5; 26 vs 143 at 244k)
            amg_opts = dict(
                strength_theta=(0.15, 0.05), omega=0.0, coarse_n=2500,
            )
            amg_opts.update(self.u_amg_opts or {})
            hier = build_amg(
                self._k_ie, dtype=self.dtype, semidefinite=True,
                cache_key=self.cache_key,
                **amg_opts,
            )
        self._dct_dims = spec[1] if spec is not None else None
        self._u_dct = spec is not None  # exposed for tests
        self._u_amg = hier is not None  # exposed for tests

        # the operator streams / eigenvalue array / AMG hierarchy ride
        # the jit call as an explicit operand pytree (one host->device
        # push; no large constants baked into the compiled program)
        lam_dev = jax.device_put(jnp.asarray(spec[0])) if spec is not None else None
        gs_lams = None
        if self.scheme == "gs" and spec is not None:
            # per-operator DCT eigenvalue models for the parabolic block:
            # eigenvalues of the SAME transform add, so the per-dt
            # ``lam_A = C_m lam_M + theta dt lam_Ki`` combine runs on two
            # tiny [dims] arrays per chunk (mirrors the operator-stream
            # combine below)
            spec_m = stencil_dct_eigenvalues(self._mass, self.mesh, dtype=self.dtype)
            spec_ki = stencil_dct_eigenvalues(self._k_i, self.mesh, dtype=self.dtype)
            if spec_m is not None and spec_ki is not None:
                gs_lams = (
                    jax.device_put(jnp.asarray(spec_m[0])),
                    jax.device_put(jnp.asarray(spec_ki[0])),
                )
        k_ie_dev = self._k_ie.to_device()
        self._operands = (
            self._mass.to_device(),
            self._k_i.to_device(),
            k_ie_dev,
            lam_dev,
            hier.to_device(level0_A=k_ie_dev) if hier is not None else None,
            gs_lams,
        )
        u_dims = self._dct_dims
        _dct_solve = dct_solve
        _amg_apply = amg_apply
        C_m = float(self.C_m)
        th_pde = float(self.pde_theta)
        th = float(self.theta)
        godunov = np.isclose(th, 1.0)
        vi = self.v_index
        from .device import platform_of
        from .ops.ionic_kernel import make_ionic_step

        # exposed for tests and benchmarks
        self.ionic_route, ionic_step = make_ionic_step(
            self.ode_fun,
            self.states.shape[0],
            self._params,
            vi,
            platform_of(self.states),
            self.ionic_kernel,
        )

        def ode_fun(states, t, dt):
            return ionic_step(states, states[vi], t, dt)

        terms, b_units = self._stim_terms, self._b_units
        rtol, atol, maxiter = self.cg_rtol, self.cg_atol, self.cg_maxiter
        scheme_gs = self.scheme == "gs"
        gs_v_rtol = self.gs_v_rtol if self.gs_v_rtol is not None else rtol
        gs_u_rtol = self.gs_u_rtol if self.gs_u_rtol is not None else rtol
        u_every = int(self.u_solve_every)

        def b_stim(t, amps):
            b = 0.0
            for i, quad, expr, b_idx, window in terms:
                if b_idx is not None:
                    start, dur = window
                    on = jnp.where((t >= start) & (t <= start + dur), 1.0, 0.0)
                    b = b + (amps[i] * on) * b_units[b_idx]
                else:
                    b = b + amps[i] * quad.assemble_load(expr, t)
            return b

        def build_step_ops(ops, dt):
            # per-dt operator combinations: ONE value-combined stream per
            # block instead of separate mass/k_i applications (the streams
            # share one sparsity pattern).  dt is invariant within a
            # chunk, so this runs ONCE per chunk, OUTSIDE the scan —
            # materializing the combined value streams per step would add
            # ~3 full operator-stream writes to every step's HBM traffic
            # (fused.py hoists the same way)
            mass, k_i, k_ie, u_lam, u_amg, gs_lams = ops
            A_op = mass.combine(C_m, k_i, th_pde * dt)
            B_op = mass.combine(C_m, k_i, -(1.0 - th_pde) * dt)
            mvA = lambda x: A_op @ x  # noqa: E731
            mvB = lambda x: B_op @ x  # noqa: E731
            mvKi = lambda x: k_i @ x  # noqa: E731
            mvKie = lambda x: k_ie @ x  # noqa: E731
            diag_v = A_op.diagonal()
            diag_kie = k_ie.diagonal()
            # parabolic-block DCT eigenvalue model at this dt (gs scheme)
            v_lam = None
            if gs_lams is not None:
                lam_m, lam_ki = gs_lams
                v_lam = C_m * lam_m + (th_pde * dt) * lam_ki
            return mvA, mvB, mvKi, mvKie, diag_v, diag_kie, u_lam, u_amg, v_lam

        def one_step_gs(sops, carry, t, dt, amps, k):
            # Gauss-Seidel decoupled step: parabolic v-solve with the
            # lagged u_e, then the elliptic constraint (the block
            # system's second row with v at its theta point) — ONE
            # combined operator stream per CG iteration in each solve,
            # vs the monolithic step's four
            mvA, mvB, mvKi, mvKie, diag_v, diag_kie, u_lam, u_amg, v_lam = sops
            states, u_e, dvu = carry
            states = ode_fun(states, t, th * dt)
            v = states[vi]
            ts = t + th_pde * dt
            # one-step linear extrapolation of the lagged u_e (the warm
            # -start increment is exactly u_e^k - u_e^{k-1}): upgrades the
            # coupling lag from O(dt) to O(dt^2) where u_e is smooth in
            # time, at zero extra operator traffic (measured vs
            # monolithic at dt=0.05: rel err 0.025% -> 0.002% (v) and
            # 0.056% -> 0.005% (u_e) on the 3D slab; 1.1% -> <0.5% on
            # the 2D stimulus-onset transient)
            rhs_v = mvB(v) - dt * mvKi(u_e + dvu[1]) + dt * b_stim(ts, amps)
            if v_lam is not None:
                v_prec = dict(precond=lambda r: _dct_solve(r, v_lam, u_dims))
            else:
                v_prec = dict(precond_diag=diag_v)
            v_new, info_v = cg(
                mvA, rhs_v, v + dvu[0], rtol=gs_v_rtol, atol=atol,
                maxiter=maxiter, **v_prec,
            )

            def deflate(x):
                return x - jnp.mean(x)

            if u_lam is not None:
                u_prec = dict(
                    precond=lambda r: deflate(_dct_solve(r, u_lam, u_dims))
                )
            elif u_amg is not None:
                u_prec = dict(precond=lambda r: deflate(_amg_apply(u_amg, r)))
            else:
                u_prec = dict(precond_diag=diag_kie)
            u_star = deflate(u_e + dvu[1])  # O(dt^2) extrapolated u_e

            def _solve_u(_):
                rhs_u = deflate(
                    -mvKi(th_pde * v_new + (1.0 - th_pde) * v)
                )
                u_new, info_u = cg(
                    lambda x: deflate(mvKie(deflate(x))), rhs_u,
                    u_star, rtol=gs_u_rtol, atol=atol,
                    maxiter=maxiter, **u_prec,
                )
                return (
                    u_new,
                    info_u.iterations,
                    info_u.residual_norm,
                    info_u.converged,
                )

            if u_every > 1:
                # elliptic cadence: the constraint is algebraic in v, so
                # skipped steps ride the extrapolation (exactly what the
                # v-solve's coupling already consumes); the solve only
                # rebases the slope every u_every steps
                u_new, it_u, rn_u, cv_u = jax.lax.cond(
                    (k % u_every) == 0,
                    _solve_u,
                    lambda _: (
                        u_star,
                        jnp.zeros((), jnp.int32),
                        jnp.zeros((), u_star.dtype),
                        jnp.ones((), jnp.bool_),
                    ),
                    None,
                )
            else:
                u_new, it_u, rn_u, cv_u = _solve_u(None)
            dvu = jnp.stack([v_new - v, u_new - u_e])
            stats = (
                info_v.iterations + it_u,
                jnp.maximum(info_v.residual_norm, rn_u),
                jnp.logical_and(info_v.converged, cv_u),
            )
            states = states.at[vi].set(v_new)
            if not godunov:
                states = ode_fun(states, t + th * dt, (1.0 - th) * dt)
            carry_out = (states, u_new, dvu)
            return carry_out, stats

        def one_step(sops, carry, t, dt, amps, k):
            del k  # monolithic: every step solves the full block system
            mvA, mvB, mvKi, mvKie, diag_v, diag_kie, u_lam, u_amg, _v_lam = sops
            # general theta splitting: tentative theta*dt ionic step, PDE
            # over dt, corrective (1-theta)*dt ionic step (the reference's
            # choreography, monodomain_solver.py:53-116 there)
            states, u_e, dvu = carry
            states = ode_fun(states, t, th * dt)
            v = states[vi]
            ts = t + th_pde * dt  # stimulus at the PDE theta point
            rhs_v = mvB(v) + dt * b_stim(ts, amps)
            rhs_u = -(dt / th_pde) * (1.0 - th_pde) * mvKi(v)
            b = jnp.stack([rhs_v, rhs_u])

            def deflate(x):
                # remove the constant-u_e nullspace component: CG on the
                # singular-consistent system is exact-arithmetic-safe, but
                # in f32 rounding feeds the nullspace and the Krylov basis
                # loses orthogonality (measured: divergence to 1e8 within
                # 20 steps); projecting in/out of the matvec keeps the
                # iteration on the regular subspace
                return x.at[1].add(-jnp.mean(x[1]))

            def matvec(x):
                x = deflate(x)
                xv, xu = x[0], x[1]
                yv = mvA(xv) + dt * mvKi(xu)
                yu = dt * mvKi(xv) + (dt / th_pde) * mvKie(xu)
                return deflate(jnp.stack([yv, yu]))

            if u_lam is not None or u_amg is not None:
                # block preconditioner: Jacobi on the mass-dominated v
                # block, spectral DCT inverse (structured constant-coeff)
                # or SA-AMG V-cycle (everything else) on the elliptic u
                # block (system u-block is (dt/theta) K_ie -> scale by
                # theta/dt)
                def precond(r):
                    zv = r[0] / diag_v
                    if u_lam is not None:
                        zu = _dct_solve(r[1], u_lam, u_dims)
                    else:
                        zu = _amg_apply(u_amg, r[1])
                    zu = (th_pde / dt) * zu
                    zu = zu - jnp.mean(zu)
                    return jnp.stack([zv, zu])

                prec_kwargs = dict(precond=precond)
            else:
                prec_kwargs = dict(
                    precond_diag=jnp.stack([diag_v, (dt / th_pde) * diag_kie])
                )
            x0 = jnp.stack([v, u_e]) + dvu
            x0 = x0.at[1].add(-jnp.mean(x0[1]))
            b = b.at[1].add(-jnp.mean(b[1]))
            x, info = cg(
                matvec, b, x0, rtol=rtol, atol=atol, maxiter=maxiter,
                **prec_kwargs,
            )
            v_new, u_new = x[0], x[1]
            dvu = x - jnp.stack([v, u_e])  # warm-start increment
            states = states.at[vi].set(v_new)
            if not godunov:
                states = ode_fun(states, t + th * dt, (1.0 - th) * dt)
            carry_out = (states, u_new, dvu)
            return carry_out, (info.iterations, info.residual_norm, info.converged)

        from functools import partial

        @partial(jax.jit, static_argnums=6)
        def run_chunk(ops, states, u_e, t0, dt, amps, n_steps):
            dvu0 = jnp.zeros((2, states.shape[1]), dtype=states.dtype)
            sops = build_step_ops(ops, dt)

            step_fn = one_step_gs if scheme_gs else one_step

            def body(carry, k):
                t = t0 + k * dt
                return step_fn(sops, carry, t, dt, amps, k)

            (states, u_e, _), (iters, rnorms, convs) = jax.lax.scan(
                body, (states, u_e, dvu0), jnp.arange(n_steps)
            )
            # ground the floating extracellular constant to zero mean
            u_e = u_e - jnp.mean(u_e)
            # worst-step stats so the recorded CGInfo triple is
            # self-consistent (max iterations WITH max residual)
            return states, u_e, jnp.max(iters), jnp.max(rnorms), jnp.all(convs)

        self._run_chunk = lambda *a: run_chunk(self._operands, *a)

    # ------------------------------------------------------------------
    @property
    def v(self) -> jnp.ndarray:
        return self.states[self.v_index]

    def stimulus_amplitudes(self) -> jnp.ndarray:
        amps = [
            float(s.expr.amplitude) if (s is not None and hasattr(s.expr, "amplitude")) else 1.0
            for _, _, s in self._stim_quads
        ]
        return jnp.asarray(amps or [0.0], dtype=self.dtype)

    def solve(
        self,
        interval: tuple[float, float],
        dt: float,
        save_freq: int | None = None,
        save_callback: Callable | None = None,
    ) -> Status:
        """March (T0, T] in fused chunks; ``save_callback(t, v, u_e)``
        receives host copies at chunk boundaries."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        amps = self.stimulus_amplitudes()
        t = float(T0)
        ok = True
        done = 0
        from .ops.cg import CGInfo

        while done < n_total:
            n = min(chunk, n_total - done)
            self.states, self.u_e, iters, rnorm, conv = self._run_chunk(
                self.states,
                self.u_e,
                jnp.asarray(t, dtype=self.dtype),
                jnp.asarray(dt, dtype=self.dtype),
                amps,
                n,
            )
            done += n
            t = T0 + done * dt
            ok = ok and bool(conv)
            self.monitor.record_ksp(
                CGInfo(
                    iterations=int(iters),
                    residual_norm=float(rnorm),
                    converged=bool(conv),
                )
            )
            if save_callback is not None:
                save_callback(t, np.asarray(self.v), np.asarray(self.u_e))
        return Status.OK if ok else Status.NOT_CONVERGING
