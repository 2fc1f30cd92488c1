"""Fused on-device splitting solver — the performance path.

The object-oriented :class:`~fenicsx_beat_tpu.monodomain_solver.
MonodomainSplittingSolver` replicates the reference's per-step host
choreography (``monodomain_solver.py:53-116``): 8+ host->device
transitions per step.  This module compiles the ENTIRE time loop --
ionic Rush-Larsen step, voltage exchange, theta-rule CG solve, activation
tracking -- into one ``jax.lax.scan`` per save interval, so a whole
simulation runs with zero host round-trips except at save points.

Requirements of the fused path (the standard production configuration):
the ODE space equals the PDE space (P1 nodes), and the ionic RHS is
jax-traceable.  Everything else (transfer adapters, multi-space) stays on
the OO path.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import fem
from .base_model import Status, _as_expr, _transform_I_s
from .config import default_dtype
from .conductivities import as_cell_tensors
from .mesh import Mesh
from .ops.cg import CGInfo, cg
from .stimulation import dx as dx_measure
from .telemetry import BaseMonitor, NullMonitor

__all__ = ["FusedMonodomainSolver"]

logger = logging.getLogger(__name__)


@dataclass
class FusedMonodomainSolver:
    """Monodomain operator-splitting solver fully fused under jit.

    Parameters
    ----------
    mesh : Mesh
    M : conductivity spec (scalar / tensor / ConductivityTensor)
    ode_fun : jax-traceable ``fun(states, t, parameters, dt) -> states``
        over a (num_states, n_nodes) array (the reference ODE contract,
        ``odesolver.py:67-79``).
    init_states : (num_states,) or (num_states, n_nodes)
    parameters : model parameter vector (or None)
    v_index : voltage row in the state array
    I_s : Stimulus | list[Stimulus] | callable
    theta : 1.0 Godunov / 0.5 Strang (``monodomain_solver.py:94-113``)
    C_m, dt-independent set-up mirrors MonodomainModel.
    """

    mesh: Mesh
    M: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0  # splitting scheme (Godunov 1.0 / Strang 0.5)
    pde_theta: float = 0.5  # PDE time discretization (reference default
    # parameters use Crank-Nicolson regardless of the splitting theta,
    # base_model.py:158-168)
    C_m: float = 1.0
    params: dict | None = None
    monitor: BaseMonitor = None  # type: ignore[assignment]
    activation_threshold: float = 0.0
    dtype: Any = None
    probe_points: Any = None  # [np, gdim] physical probe coordinates
    ode_markers: Any = None  # per-node marker array/Function: multi-model
    operator_cache_key: str | None = None  # opt-in disk cache of assembly
    # Strang (theta=0.5) only: regroup adjacent ionic half-steps into one
    # full-dt step per chunk interior — same 2nd-order splitting, ~the
    # ionic cost of Godunov.  Off by default: the reference's unmerged
    # choreography (monodomain_solver.py:99-113 there) is the
    # cross-validation target of tests/test_fused.py.
    merge_strang_halves: bool = False
    # ionic step route (ops/ionic_kernel.select_route): None = the Pallas
    # kernel when the state lives on a GPU and the model qualifies, XLA
    # otherwise; "xla" forces the jnp model, "interpret" runs the kernel
    # in the Pallas interpreter (CPU tests)
    ionic_kernel: str | None = None

    def __post_init__(self):
        self.monitor = self.monitor or NullMonitor()
        self.dtype = self.dtype or default_dtype()
        p = {
            "quadrature_degree": 4,
            "ksp_rtol": 1e-8 if self.dtype == jnp.float64 else 1e-6,
            "ksp_atol": 1e-10 if self.dtype == jnp.float64 else 1e-7,
            "ksp_max_it": 1000,
        }
        p.update(self.params or {})
        self._opts = p

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self.V.ndofs

        # multi-marker ionic models (DolfinMultiODESolver semantics,
        # reference odesolver.py:228-354): dicts keyed by marker compose
        # into one traceable step whose `parameters` are the node masks
        self._ode_masks = None
        if isinstance(self.ode_fun, dict):
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
        # shared stencil-first assembly (fem.assemble_mass_stiffness_auto):
        # direct stencil on structured meshes — no COO sort, no [nc,4,4]
        # element tensor (the generic pipeline needs >30 min of host time
        # at the 20M-cell dx=0.05 resolution) — generic ELL otherwise
        self._mass, self._stiff = fem.assemble_mass_stiffness_auto(
            self.V, M_cells, dtype=self.dtype, cache_key=self.operator_cache_key
        )

        from .stimulation import TimeWindow

        stimuli = _transform_I_s(self.I_s, dZ=dx_measure(self.mesh))
        self._stim_quads = []
        for s in stimuli:
            ents = s.dz.entities()
            if len(ents) == 0:
                continue
            if s.dz.integral_type() == "cell":
                quad = fem.cell_quadrature(self.V, ents, degree=p["quadrature_degree"], dtype=self.dtype)
            else:
                quad = fem.facet_quadrature(self.V, ents, degree=p["quadrature_degree"], dtype=self.dtype)
            # TimeWindow amplitudes become traced per-chunk arguments so
            # Stimulus.assign takes effect at the next chunk
            if isinstance(s.expr, TimeWindow):
                self._stim_quads.append((quad, s.expr.indicator, s))
            else:
                self._stim_quads.append((quad, _as_expr(s.expr), None))

        self._n = n
        init = np.asarray(self.init_states, dtype=np.float64)
        states = np.tile(init[:, None], (1, n)) if init.ndim == 1 else init
        self.states = jnp.asarray(states, dtype=self.dtype)
        self.activation_time = jnp.full((n,), -1.0, dtype=self.dtype)
        npdt = np.dtype(jnp.dtype(self.dtype).name)
        if self._ode_masks is not None:
            self._params_j = np.asarray(self._ode_masks)
        elif self.parameters is not None and np.ndim(self.parameters) == 2:
            self._params_j = np.asarray(self.parameters, dtype=np.float64).astype(npdt)
        else:
            self._params_j = (
                None if self.parameters is None else np.asarray(self.parameters, dtype=npdt)
            )
        if self.probe_points is not None:
            pdofs, pw = fem.point_evaluation_tables(self.V, np.asarray(self.probe_points))
            self._probe_tables = (np.asarray(pdofs), np.asarray(pw, dtype=npdt))
        else:
            self._probe_tables = None
        self._build_kernels()

    # ------------------------------------------------------------------
    def _build_kernels(self):
        mass, stiff = self._mass, self._stiff
        theta = float(self.theta)
        pde_theta = float(self.pde_theta)
        merged = bool(self.merge_strang_halves) and np.isclose(theta, 0.5)
        if self.merge_strang_halves and not merged:
            logger.warning(
                "merge_strang_halves requires theta=0.5 (got %g); ignored",
                theta,
            )
        C_m = float(self.C_m)
        rtol = float(self._opts["ksp_rtol"])
        atol = float(self._opts["ksp_atol"])
        maxiter = int(self._opts["ksp_max_it"])
        stim_quads = self._stim_quads
        v_index = self.v_index
        thr = float(self.activation_threshold)

        params_closure = self._params_j
        jnp_ode_fun = self.ode_fun

        # Device-resident operands, threaded through the jitted chunk as an
        # ARGUMENT pytree: one host->device push, and no large constants
        # baked into the compiled program
        operands = {}

        from .device import platform_of
        from .ops.ionic_kernel import make_ionic_step

        # exposed for tests and benchmarks
        self.ionic_route, ionic_step = make_ionic_step(
            jnp_ode_fun,
            self.states.shape[0],
            params_closure,
            v_index,
            platform_of(self.states),
            self.ionic_kernel,
        )

        def ode_apply(op, states, v, t, dt):
            """Ionic step with the live voltage row injected."""
            return ionic_step(states, v, t, dt)

        operands["mass"] = mass.to_device()
        operands["stiff"] = stiff.to_device()

        def build_operators(op, dt):
            A = op["mass"].combine(C_m, op["stiff"], pde_theta * dt)
            B = op["mass"].combine(C_m, op["stiff"], -(1.0 - pde_theta) * dt)
            return (A, B, A.diagonal())

        # TimeWindow stimuli are separable (purely temporal window x fixed
        # spatial load): precompute the unit load vector once instead of a
        # per-step quadrature scatter-add
        from .stimulation import separable_stimulus_terms

        stim_terms, b_units_np = separable_stimulus_terms(stim_quads)
        if b_units_np:
            npdt = np.dtype(jnp.dtype(self.dtype).name)
            # unit loads ride in the operand pytree as one device array
            operands["b_units"] = jax.device_put(
                jnp.asarray(np.stack(b_units_np).astype(npdt))
            )

        def _assemble_rhs(op, ops, v_prev, t, dt, amps):
            b = ops[1] @ v_prev
            for i, quad, expr, b_idx, window in stim_terms:
                if b_idx is not None:
                    start, dur = window
                    on = jnp.where((t >= start) & (t <= start + dur), 1.0, 0.0)
                    b = b + (dt * amps[i] * on) * op["b_units"][b_idx]
                else:
                    b = b + (dt * amps[i]) * quad.assemble_load(expr, t)
            return b

        def pde_solve(op, ops, v_prev, x0, t, dt, amps):
            b = _assemble_rhs(op, ops, v_prev, t, dt, amps)
            x, info = cg(
                lambda u: ops[0] @ u,
                b,
                x0,
                precond_diag=ops[2],
                rtol=rtol,
                atol=atol,
                maxiter=maxiter,
            )
            return x, info.iterations, info.residual_norm, info.converged

        @partial(jax.jit, static_argnames=("n_steps",))
        def run_chunk_ops(op, states, act, t0, dt, amps, n_steps):
            # theta-system operators are dt-invariant within the chunk:
            # build once, outside the scan
            ops = build_operators(op, dt)

            def one_step(carry, k):
                # the PDE-updated voltage rides as a separate carry row and
                # is injected at the next ionic step
                states, act, t, dv, v_cur = carry
                if merged:
                    # Merged Strang: adjacent corrective+tentative ionic
                    # half-steps regroup into ONE full-dt ionic step —
                    # A(dt/2) [B(dt) A(dt)]^{n-1} B(dt) A(dt/2) per chunk —
                    # halving the ionic cost of interior steps while each
                    # chunk remains an exact Strang composition.
                    tent_dt = jnp.where(k == 0, 0.5 * dt, dt)
                else:
                    tent_dt = theta * dt
                # tentative ODE step (monodomain_solver.py:68)
                states = ode_apply(op, states, v_cur, t, tent_dt)
                v = states[v_index]
                if merged:
                    # Midpoint activation sampling: the previous interior
                    # step's TRUE Strang observation is A(dt/2) applied to
                    # its post-PDE state.  The voltage row advances by
                    # forward Euler (v' = v + dt*f_v with f_v frozen at the
                    # step's start), so that sample's voltage is exactly
                    #   A(dt/2).v = v_cur + (dt/2) f_v = (v_cur + v)/2
                    # — the midpoint of the carried post-PDE voltage and
                    # this step's post-A(dt) voltage, for free.  Without
                    # this, thresholding the post-PDE samples reads the
                    # half-shifted composition A(-dt/2)*Strang_k and the
                    # measured activation error collapses to Godunov's
                    # (docs/DESIGN.md §8).
                    v_mid = 0.5 * (v_cur + v)
                    act = jnp.where(
                        (k > 0) & (v_mid > thr) & (act < 0), t - dt, act
                    )
                # PDE theta-step over dt; stimulus evaluated at the PDE
                # theta point (reference base_model.py:219); CG warm-started
                # with the previous step's solve increment (the trajectory
                # is smooth in time, so v + dv is a better x0 than v)
                v_new, iters, rnorm, conv = pde_solve(
                    op, ops, v, v + dv, t + pde_theta * dt, dt, amps
                )
                dv = v_new - v
                if not merged and not np.isclose(theta, 1.0):
                    # corrective ODE step (Strang, monodomain_solver.py:99-113)
                    states = ode_apply(op, states, v_new, t + theta * dt, (1.0 - theta) * dt)
                    v_new = states[v_index]
                t_next = t + dt
                if not merged:
                    act = jnp.where((v_new > thr) & (act < 0), t, act)
                # merged: interior steps are observed as midpoints at the
                # NEXT step (above); the trailing A(dt/2) close runs ONCE
                # after the scan (a lax.cond inside the scan would sever the
                # states buffer's aliasing chain and re-introduce a full
                # states copy per step)
                return (states, act, t_next, dv, v_new), (iters, rnorm, conv)

            v0 = states[v_index]
            dv0 = jnp.zeros_like(v0)
            (states, act, t, _, v_last), (iters, rnorms, convs) = jax.lax.scan(
                one_step,
                (states, act, t0, dv0, v0),
                jnp.arange(n_steps),
            )
            if merged:
                # trailing A(dt/2) closes the chunk's Strang composition;
                # its voltage is the chunk-final step's direct sample
                states = ode_apply(op, states, v_last, t, 0.5 * dt)
                v_last = states[v_index]
                act = jnp.where((v_last > thr) & (act < 0), t - dt, act)
            # one voltage-row write-back per chunk instead of per step
            states = states.at[v_index].set(v_last)
            # real per-chunk linear-solver stats (reference records the KSP
            # converged_reason per solve, telemetry.py:67-76 there)
            return (
                states,
                act,
                t,
                jnp.max(iters),
                jnp.sum(iters),
                rnorms[-1],
                jnp.all(convs),
            )

        self._operands = operands

        def run_chunk(states, act, t0, dt, amps, n_steps):
            return run_chunk_ops(self._operands, states, act, t0, dt, amps, n_steps)

        self._run_chunk = run_chunk
        self._run_chunk_ops = run_chunk_ops
        probe_tables = self._probe_tables

        @partial(jax.jit, static_argnames=("n_steps",))
        def run_chunk_probed_ops(op, states, act, t0, dt, amps, n_steps):
            """One invocation returning probe activation values too — keeps
            host round-trips to one per chunk."""
            states, act, t, it_max, it_sum, rnorm, conv = run_chunk_ops(
                op, states, act, t0, dt, amps, n_steps
            )
            pdofs, pw = probe_tables
            probes = jnp.sum(act[pdofs] * pw, axis=1)
            return states, act, t, it_max, it_sum, rnorm, conv, probes

        def run_chunk_probed(states, act, t0, dt, amps, n_steps):
            return run_chunk_probed_ops(
                self._operands, states, act, t0, dt, amps, n_steps
            )

        self._run_chunk_probed = run_chunk_probed if probe_tables is not None else None

    # ------------------------------------------------------------------
    def stimulus_amplitudes(self) -> jnp.ndarray:
        """Live amplitude vector (read each chunk; 1.0 for non-TimeWindow
        exprs whose value is baked into the traced callable)."""
        amps = [
            float(stim.expr.amplitude) if stim is not None else 1.0
            for _, _, stim in self._stim_quads
        ]
        return jnp.asarray(amps or [0.0], dtype=self.dtype)

    @property
    def v(self) -> jnp.ndarray:
        return self.states[self.v_index]

    def _check_fixed_dt(self, dt: float) -> None:
        """Table-driven ionic models bake their sub-step dt at build time
        and ignore the runtime value — guard against a silent mismatch.

        The splitting scheme determines which ionic sub-steps occur: Godunov
        takes one ``theta*dt = dt`` step, Strang two ``dt/2`` steps (a single
        baked dt covers both), merged Strang additionally takes full-dt
        interior steps."""
        fixed = getattr(self.ode_fun, "fixed_dt", None)
        if fixed is None:
            return
        theta = float(self.theta)
        if self.merge_strang_halves and np.isclose(theta, 0.5):
            subs = {0.5 * dt, float(dt)}
        elif np.isclose(theta, 1.0):
            subs = {float(dt)}
        else:
            subs = {theta * dt, (1.0 - theta) * dt}
        bad = [s for s in subs if not np.isclose(s, float(fixed), rtol=1e-10)]
        if bad:
            raise ValueError(
                f"ode_fun bakes dt={fixed} but the {theta=} splitting at "
                f"dt={dt} takes ionic sub-steps {sorted(subs)}; rebuild the "
                f"tabulated model with the matching sub-step dt"
            )

    def solve(
        self,
        interval: tuple[float, float],
        dt: float,
        save_freq: int | None = None,
        save_callback: Callable[[float, np.ndarray], None] | None = None,
    ) -> Status:
        """Run the fused time loop on (T0, T].

        ``save_freq`` (in steps) bounds chunk length; ``save_callback(t,
        v_host)`` fires once per chunk with the voltage synced to host —
        the only host round-trip of the loop.

        Returns ``Status.NOT_CONVERGING`` if any step's CG stopped at
        ``ksp_max_it`` without meeting tolerance (mirrors the reference's
        KSP converged_reason plumbing, ``base_model.py:23-25`` there);
        ``Status.OK`` otherwise."""
        T0, T = interval
        self._check_fixed_dt(dt)
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        t = jnp.asarray(T0, dtype=self.dtype)
        dtj = jnp.asarray(dt, dtype=self.dtype)
        done = 0
        all_converged = True
        while done < n_total:
            n = min(chunk, n_total - done)
            with self.monitor.track_time("fused_chunk"):
                (
                    self.states,
                    self.activation_time,
                    t,
                    it_max,
                    it_sum,
                    rnorm,
                    conv,
                ) = self._run_chunk(
                    self.states, self.activation_time, t, dtj, self.stimulus_amplitudes(), n
                )
                self.states.block_until_ready()
            done += n
            converged = bool(conv)
            all_converged &= converged
            if not converged:
                logger.warning(
                    "CG did not converge within ksp_max_it during chunk ending "
                    "t=%g (last residual norm %.3e)",
                    float(t),
                    float(rnorm),
                )
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
        return np.asarray(self.activation_time)

    # ------------------------------------------------------------------
    # full-state checkpoint / resume (reference does this via external
    # ADIOS2 checkpoints, demos/pace_train.py:179-189)
    def save_state(self, path, t: float = 0.0):
        """Write the complete solver state (all ionic states, activation
        times, simulation time) to one npz for exact resume.

        Checkpoints hold exactly the mesh's nodes, so they are portable
        across solvers (the sharded solver pads to a device multiple)."""
        from pathlib import Path

        out = Path(path).with_suffix(".npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out,
            states=np.asarray(self.states),
            activation_time=np.asarray(self.activation_time),
            t=float(t),
            v_index=self.v_index,
        )
        return out

    def load_state(self, path) -> float:
        """Restore a :meth:`save_state` checkpoint; returns its time."""
        from pathlib import Path

        with np.load(Path(path).with_suffix(".npz")) as f:
            states = f["states"]
            act = f["activation_time"]
            if states.shape != self.states.shape:
                raise ValueError(
                    f"checkpoint shape {states.shape} incompatible with "
                    f"solver ({self.states.shape[0]} states, {self._n} nodes; "
                    "different mesh or ionic model?)"
                )
            if int(f["v_index"]) != int(self.v_index):
                raise ValueError(
                    f"checkpoint v_index {int(f['v_index'])} != solver "
                    f"{self.v_index} (different ionic model?)"
                )
            self.states = jnp.asarray(states, dtype=self.dtype)
            self.activation_time = jnp.asarray(act, dtype=self.dtype)
            return float(f["t"])
