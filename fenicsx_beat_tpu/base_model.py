"""Abstract parabolic PDE stepper (theta rule) on precompiled operators.

JAX counterpart of reference ``src/beat/base_model.py``.  Design
differences, driven by XLA semantics:

* The reference assembles a PETSc matrix once and re-assembles it when dt
  changes (``base_model.py:188-194,225-230``).  Here mass and stiffness are
  assembled once into ELL matrices with a *shared sparsity pattern*, and the
  theta-scheme operator ``A = C_m*Mass + theta*dt*K`` is formed value-wise
  inside jit with dt as a traced argument — a dt change costs nothing and
  triggers no recompilation.
* The per-step pipeline (RHS assembly -> ghost update -> KSP solve ->
  scatter_forward, ``base_model.py:196-242``) collapses into one jitted
  kernel: quadrature-point load evaluation, two fused SpMVs, and an
  on-device Jacobi-CG ``lax.while_loop``.
"""

from __future__ import annotations

import abc
import logging
from enum import Enum, auto
from typing import Any, Literal, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fem
from .config import default_dtype
from .mesh import Mesh
from .ops.cg import cg
from .stimulation import Measure, Stimulus, dx as dx_measure
from .telemetry import BaseMonitor, NullMonitor

logger = logging.getLogger(__name__)

__all__ = ["Status", "Results", "BaseModel"]


class Status(str, Enum):
    OK = auto()
    NOT_CONVERGING = auto()


class Results(NamedTuple):
    state: fem.Function
    status: Status


def _transform_I_s(I_s, dZ: Measure) -> list[Stimulus]:
    """Normalize the stimulus argument to a list of Stimulus
    (mirrors reference ``base_model.py:33-45``)."""
    if I_s is None:
        return []
    if isinstance(I_s, Stimulus):
        return [I_s]
    if callable(I_s) or np.isscalar(I_s):
        return [Stimulus(expr=I_s, dZ=dZ)]
    return list(I_s)


def _as_expr(expr):
    """Wrap scalars as constant space-time callables."""
    if callable(expr):
        return expr
    val = float(expr)
    return lambda x, t: val * jnp.ones_like(x[0])


class BaseModel(abc.ABC):
    """Base class for theta-rule parabolic models.

    Parameters mirror the reference (``base_model.py:73-124``): ``time`` is
    a mutable :class:`fem.Constant`, ``I_s`` a Stimulus / sequence /
    callable, ``params`` override :meth:`default_parameters`.
    """

    def __init__(
        self,
        time: fem.Constant,
        mesh: Mesh,
        dx: Measure | None = None,
        params: dict[str, Any] | None = None,
        I_s=None,
        monitor: BaseMonitor | None = None,
        **kwargs: Any,
    ) -> None:
        if kwargs:
            logger.warning(
                "Unused keyword arguments: %s",
                ", ".join(f"{k}={v}" for k, v in kwargs.items()),
            )

        self._mesh = mesh
        self.time = time
        self.dx = dx or dx_measure(mesh)
        self.monitor = monitor or NullMonitor()

        self.parameters = type(self).default_parameters()
        if params is not None:
            self.parameters.update(params)

        self._I_s = _transform_I_s(I_s, dZ=self.dx)
        self._setup_state_space()
        self._timestep = fem.Constant(self.parameters["default_timestep"])
        self._dtype = default_dtype()
        self._setup_solver()

    # ------------------------------------------------------------------
    @abc.abstractmethod
    def _setup_state_space(self) -> None: ...

    @property
    @abc.abstractmethod
    def state(self) -> fem.Function: ...

    @abc.abstractmethod
    def assign_previous(self) -> None: ...

    @abc.abstractmethod
    def _operators(self):
        """Return (mass_ell, stiff_ell, C_m) for the theta system."""
        ...

    # ------------------------------------------------------------------
    @staticmethod
    def default_parameters(
        solver_type: Literal["iterative", "direct"] = "direct",
    ) -> dict[str, Any]:
        """Defaults mirroring reference ``base_model.py:136-168``.

        ``petsc_options`` keys are interpreted by the in-repo CG solver:
        direct -> very tight CG tolerances (LU-equivalent accuracy);
        iterative -> the reference's CG profile.
        """
        if solver_type == "iterative":
            petsc_options = {"ksp_type": "cg", "ksp_rtol": 1e-8, "ksp_atol": 1e-12}
        else:
            petsc_options = {"ksp_type": "preonly", "pc_type": "lu"}
        return {
            "theta": 0.5,
            "degree": 1,
            "family": "Lagrange",
            "default_timestep": 1.0,
            "jit_options": {},
            "form_compiler_options": {},
            "petsc_options": petsc_options,
            "quadrature_degree": 4,
            "log_timings": False,
            "timing_log_frequency": 1,
        }

    # ------------------------------------------------------------------
    def _solver_tolerances(self) -> tuple[float, float, int]:
        opts = self.parameters.get("petsc_options") or {}
        if opts.get("ksp_type", "preonly") == "preonly" or opts.get("pc_type") == "lu":
            rtol, atol = 1e-13, 1e-14
        else:
            rtol = float(opts.get("ksp_rtol", 1e-8))
            atol = float(opts.get("ksp_atol", 1e-12))
        maxiter = int(opts.get("ksp_max_it", 10_000))
        if self._dtype == jnp.float32:
            rtol = max(rtol, 1e-6)
            atol = max(atol, 1e-8)
        return rtol, atol, maxiter

    def _stimulus_quadratures(self):
        """Precompute quadrature tables + exprs for each stimulus.

        TimeWindow amplitudes are factored out as traced arguments so
        ``Stimulus.assign`` (reference ``stimulation.py:23-24``) takes
        effect on the next step without recompilation: each entry is
        ``(quad, expr_fn, stim_or_None)`` — when the stimulus is present
        its live amplitude multiplies the traced indicator."""
        from .stimulation import stimulus_quadratures

        qdeg = int(self.parameters.get("quadrature_degree", 4))
        return stimulus_quadratures(self.V, self._I_s, degree=qdeg, dtype=self._dtype)

    def _stimulus_amplitudes(self) -> jnp.ndarray:
        """Live amplitude vector (1.0 slots for non-TimeWindow exprs)."""
        amps = [
            float(stim.expr.amplitude) if stim is not None else 1.0
            for _, _, stim in self._stim_quads_cached
        ]
        return jnp.asarray(amps or [0.0], dtype=self._dtype)

    def _setup_solver(self) -> None:
        mass, stiff, C_m = self._operators()
        # prefer the gather-free stencil form on structured meshes
        from .ops.sparse import ELLMatrix, ell_to_stencil

        if isinstance(mass, ELLMatrix):
            mass_st = ell_to_stencil(mass)
            stiff_st = ell_to_stencil(stiff) if mass_st is not None else None
            if stiff_st is not None and stiff_st.offsets == mass_st.offsets:
                mass, stiff = mass_st, stiff_st
        # assembly is numpy-backed; the jitted step kernel embeds the host
        # value arrays as module constants
        self._mass = mass
        self._stiff = stiff
        self._C_m = float(C_m) if np.isscalar(C_m) or isinstance(C_m, (int, float)) else C_m
        stim_quads = self._stimulus_quadratures()
        self._stim_quads_cached = stim_quads
        rtol, atol, maxiter = self._solver_tolerances()
        theta = float(self.parameters["theta"])

        # separable TimeWindow loads precomputed host-side (shared helper,
        # see stimulation.separable_stimulus_terms)
        from .stimulation import separable_stimulus_terms

        stim_terms, b_units_np = separable_stimulus_terms(stim_quads)

        # device-resident operands threaded as jit ARGUMENTS (one
        # host->device push; no large constants in the compiled program)
        operands = {
            "mass": mass.to_device(),
            "stiff": stiff.to_device(),
        }
        if b_units_np:
            operands["b_units"] = jax.device_put(jnp.asarray(np.stack(b_units_np)))
        self._operands = operands

        def step_kernel(op, v_prev, t, dt, amps):
            C_m = jnp.asarray(float(self._C_m), dtype=v_prev.dtype)
            mass, stiff = op["mass"], op["stiff"]
            A = mass.combine(C_m, stiff, theta * dt)
            b = mass.combine(C_m, stiff, -(1.0 - theta) * dt) @ v_prev
            for i, quad, expr, b_idx, window in stim_terms:
                if b_idx is not None:
                    start, dur = window
                    on = jnp.where((t >= start) & (t <= start + dur), 1.0, 0.0)
                    b = b + (dt * amps[i] * on) * op["b_units"][b_idx].astype(b.dtype)
                else:
                    b = b + (dt * amps[i]) * quad.assemble_load(expr, t)
            diag = A.diagonal()
            x, info = cg(
                lambda v: A @ v,
                b,
                v_prev,
                precond_diag=diag,
                rtol=rtol,
                atol=atol,
                maxiter=maxiter,
            )
            return x, info

        jitted = jax.jit(step_kernel)

        def _step(v_prev, t, dt, amps):
            return jitted(self._operands, v_prev, t, dt, amps)

        self._step_kernel = _step

    def _update_matrices(self) -> None:
        """No-op: dt is a traced argument of the jitted step (the reference
        re-assembles here, ``base_model.py:188-194``)."""

    def _update_rhs(self) -> None:
        """No-op: RHS assembly is fused into the jitted step."""

    # ------------------------------------------------------------------
    def step(self, interval) -> None:
        """Perform a single theta-rule step on (t0, t1)
        (mirrors reference ``base_model.py:208-245``)."""
        t0, t1 = interval
        dt = t1 - t0
        theta = self.parameters["theta"]
        t = t0 + theta * dt

        with self.monitor.track_time("pde_total_step"):
            with self.monitor.track_time("pde_set_time"):
                self.time.value = t

            timestep_unchanged = abs(dt - float(self._timestep)) < 1.0e-12
            if not timestep_unchanged:
                self._timestep.value = dt
                with self.monitor.track_time("pde_update_matrices"):
                    self._update_matrices()

            with self.monitor.track_time("pde_update_rhs"):
                self._update_rhs()

            with self.monitor.track_time("pde_linear_solve"):
                v_prev = jnp.asarray(self.v_.x.array, dtype=self._dtype)
                x, info = self._step_kernel(
                    v_prev,
                    jnp.asarray(t, dtype=self._dtype),
                    jnp.asarray(dt, dtype=self._dtype),
                    self._stimulus_amplitudes(),
                )
                x.block_until_ready()

            self.monitor.record_ksp(info)
            self._last_solve_converged = bool(info.converged)
            if not self._last_solve_converged:
                logger.warning(
                    "CG stopped at maxiter without meeting tolerance at "
                    "t=(%g, %g): residual norm %.3e after %d iterations",
                    t0,
                    t1,
                    float(info.residual_norm),
                    int(info.iterations),
                )

            with self.monitor.track_time("pde_scatter_forward"):
                self.state.x.array[:] = np.asarray(x, dtype=np.float64)

        self.monitor.advance_step(t0, t1)

    def solve(self, interval, dt: float | None = None) -> Results:
        """Solve on (T0, T); exact loop semantics of reference
        ``base_model.py:250-297`` (including no ``assign_previous`` after
        the final step — the splitting tests depend on it)."""
        T0, T = interval
        if dt is None:
            dt = T - T0
        t0 = T0
        t1 = T0 + dt

        all_converged = True
        while True:
            logger.debug("Solving on t = (%g, %g)", t0, t1)
            self.step((t0, t1))
            all_converged &= getattr(self, "_last_solve_converged", True)
            if (t1 + dt) > (T + 1e-12):
                break
            self.assign_previous()
            t0 = t1
            t1 = t0 + dt

        status = Status.OK if all_converged else Status.NOT_CONVERGING
        return Results(state=self.state, status=status)
