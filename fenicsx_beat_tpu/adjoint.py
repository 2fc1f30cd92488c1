"""Differentiable monodomain simulation: gradients through the solver.

Capability the reference does not have: fenicsx-beat's PETSc/DOLFINx
stack is opaque to autodiff (no dolfin-adjoint wiring anywhere in
``/root/reference/src/beat``).  Here the entire splitting step is a pure
JAX function, so ``jax.grad`` differentiates voltage-trace losses with
respect to

* conductivity scalings (any linear combination ``K(g) = sum_i g_i K_i``
  of pre-assembled unit stiffness operators — isotropic scale, per-region
  scales, or fiber/transverse components),
* ionic model parameters (the ``parameters`` vector of any in-repo model),
* stimulus amplitudes — ``TimeWindow`` windows, ``RandomActivation``
  patterns, and facet (``ds``) stimuli alike (start/duration/delays are
  step functions of zero-measure support and are intentionally not
  exposed).

The one non-differentiable construct — the CG ``lax.while_loop`` — is
wrapped in :func:`jax.lax.custom_linear_solve` (implicit
differentiation: the backward pass solves the SAME SPD system with the
SAME preconditioned CG, the adjoint structure of coupled PDE-ODE systems
— Farrell et al., arXiv:1708.07648).  Memory over long horizons is
bounded with ``jax.checkpoint`` on the per-step function.

Typical use (see ``demos/conductivity_fit.py`` and
``tests/test_adjoint.py``)::

    sim = build_diff_simulator(mesh, ode_fun=fhn.forward_euler, ...,
                               probe_points=pts, dt=0.1, n_steps=300)
    traces = sim(params)            # params = {"g": ..., "ionic": ...}
    loss = lambda p: jnp.mean((sim(p) - observed) ** 2)
    grads = jax.grad(loss)(params)  # reverse-mode through the PDE+ODE loop

Gradient signs and CPU/f64 finite-difference agreement are pinned in
``tests/test_adjoint.py``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from . import fem
from .ops.cg import cg
from .stimulation import TimeWindow

# f32 contractions run at full precision: the GPU may otherwise use TF32
# (~3 significant digits), far coarser than the CG tolerances used here
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "cg_implicit",
    "build_diff_simulator",
    "build_diff_bidomain_simulator",
    "host_segmented_value_and_grad",
]


def cg_implicit(
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    x0: jnp.ndarray | None = None,
    *,
    precond_diag: jnp.ndarray | None = None,
    rtol: float = 1e-10,
    atol_scaled: float = 1e-12,
    maxiter: int = 1000,
    atol: float | None = None,
    dot: Callable | None = None,
    max_abs: Callable | None = None,
) -> jnp.ndarray:
    """Differentiable SPD solve ``x = A^{-1} b``.

    Forward pass is :func:`fenicsx_beat_tpu.ops.cg.cg` (Jacobi-PCG,
    ``lax.while_loop``); reverse-mode flows through
    ``lax.custom_linear_solve`` with ``symmetric=True``, so the adjoint
    system reuses the same solver.  Gradients propagate to ``b`` AND to
    any traced values closed over by ``matvec`` (operator values, so
    conductivity parameters differentiate); ``x0``/``precond_diag`` only
    affect convergence, not the solution, and carry no gradient.

    The transpose (adjoint) solve starts from ZEROS, not ``x0``: the
    primal warm start says nothing about the cotangent system's
    solution, and a nonzero guess breaks the exact scale-equivariance
    that ``host_segmented_value_and_grad(cotangent_scale=...)`` relies
    on (with ``atol=0`` the CG iteration is bitwise equivariant under
    power-of-two RHS scaling only when the initial iterate scales too —
    zeros do).

    Both solves NORMALIZE the right-hand side by its Chebyshev norm and
    rescale the solution: CG's inner products SQUARE the operand scale,
    so an f32 adjoint seed of ~1e-22 (a ``2**-64`` cotangent scale on a
    trace loss) gives ``||b||^2 ~ 1e-44`` — below the f32 normal range,
    flushed to zero by the accelerator's arithmetic, after which the
    solve "converges" instantly and returns an exactly zero gradient.
    The max-norm
    involves no squaring, and dividing equally-scaled values is exact in
    binary FP, so normalization preserves bitwise scale-equivariance
    while making the solve robust to ANY seed scale.  Consequence:
    the absolute tolerance applies to the NORMALIZED system, i.e. it
    acts as a second relative (to ``max|b|``) tolerance — the parameter
    is therefore named ``atol_scaled`` so the semantics are explicit at
    call sites.  A true ABSOLUTE tolerance cannot coexist with the
    normalization: dividing it by ``max|b|`` would loosen the adjoint
    solve by ~20 decades for a ``2**-64``-scaled seed, reintroducing the
    instant-convergence zero-gradient failure the normalization fixes.
    ``atol`` is accepted as a deprecated alias for ``atol_scaled``.

    ``dot`` / ``max_abs`` override the inner product and the
    normalization norm — the sharded path
    (:mod:`~fenicsx_beat_tpu.parallel.adjoint`) passes psum/pmax-reduced
    versions so the solve runs collectively inside ``shard_map``."""
    if atol is not None:
        import warnings

        warnings.warn(
            "cg_implicit(atol=...) is deprecated: since the RHS is "
            "normalized by max|b|, the tolerance is relative to max|b|, "
            "not absolute — pass atol_scaled=... instead",
            DeprecationWarning,
            stacklevel=2,
        )
        atol_scaled = atol

    _max_abs = max_abs if max_abs is not None else (
        lambda r: jnp.max(jnp.abs(r))
    )

    def _solve_from(guess):
        def solve(mv, rhs):
            nb = _max_abs(rhs)
            nb = jnp.where((nb > 0) & jnp.isfinite(nb), nb, 1.0)
            x, _info = cg(
                mv,
                rhs / nb,
                None if guess is None else guess / nb,
                precond_diag=precond_diag,
                rtol=rtol,
                atol=atol_scaled,
                maxiter=maxiter,
                dot=dot,
            )
            return x * nb

        return solve

    return jax.lax.custom_linear_solve(
        matvec,
        b,
        _solve_from(x0),
        transpose_solve=_solve_from(None),
        symmetric=True,
    )


def _stack_components(V, specs, dtype, mass=None):
    """Assemble conductivity ``specs`` into one shared-pattern value stack.

    Returns ``(mass, kvals_stack, ktail_stack)``: the (first) mass
    operator carrying the sparsity pattern, the stacked stiffness value
    streams ``[n_specs, ...vals]``, and the stacked hybrid apex-tail
    values (unstructured LV meshes) or ``None``.  Pass ``mass`` to pin a
    pattern assembled earlier (the bidomain's intra/extra stacks must
    share one pattern so value-level combination stays valid)."""
    kvals_list = []
    ktail_list = []
    for spec in specs:
        m_i, k_i = fem.assemble_mass_stiffness_auto(V, spec)
        if mass is None:
            mass = m_i
        kvals_list.append(jnp.asarray(k_i.vals, dtype=dtype))
        if type(k_i) is not type(mass) or getattr(k_i, "offsets", None) != getattr(
            mass, "offsets", None
        ):
            raise ValueError("stiffness components must share the mass pattern")
        if getattr(k_i, "has_tail", False):
            # hybrid apex tail (unstructured LV meshes): value-level
            # combine like the main table — the pattern is shared across
            # components by construction (same mesh, same assembly)
            ktail_list.append(jnp.asarray(k_i.tail_vals, dtype=dtype))
    has_tail = bool(getattr(mass, "has_tail", False))
    if has_tail and len(ktail_list) != len(specs):
        raise ValueError("stiffness components disagree on the tail pattern")
    return mass, jnp.stack(kvals_list), (jnp.stack(ktail_list) if has_tail else None)


def _stimulus_setup(V, I_s, quadrature_degree, dtype, n):
    """Differentiable stimulus tables shared by the mono/bidomain diff
    simulators.

    TimeWindow protocols keep the separable fast path (one precomputed
    unit load each, amplitude the differentiable knob); everything else —
    RandomActivation patterns, arbitrary space-time callables — is
    assembled in-trace from static quadrature tables at each step
    (reference supports both kinds: ``stimulation.py:99-106`` there for
    ``ds`` facet measures, ``stimulation.py:279-363`` for random
    activation).  When the expression carries an ``amplitude`` attribute
    (TimeWindow, RandomActivation) it stays differentiable via the
    ``stim_amplitude`` parameter slot.

    Returns ``(default_amps, n_slots, b_stim)`` with
    ``b_stim(t, amps, scale) -> [n]`` the assembled load."""
    stim_loads = []
    windows = []
    win_slots: list[int] = []
    gen_quads = []
    gen_exprs = []
    gen_slots: list[int] = []
    if I_s is None:
        stimuli = []
    elif hasattr(I_s, "expr"):  # a single Stimulus (itself a tuple subclass)
        stimuli = [I_s]
    else:
        stimuli = list(I_s)
    for slot, s in enumerate(stimuli):
        ents = s.dz.entities()
        if s.dz.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=quadrature_degree, dtype=np.float64)
        else:
            # facet (ds) stimuli: surface quadrature, same contract
            # (reference semantics: ``stimulation.py:99-106`` there)
            quad = fem.facet_quadrature(V, ents, degree=quadrature_degree, dtype=np.float64)
        if isinstance(s.expr, TimeWindow):
            stim_loads.append(
                jnp.asarray(np.asarray(quad.assemble_load_host()), dtype=dtype)
            )
            windows.append((float(s.expr.start), float(s.expr.duration)))
            win_slots.append(slot)
        else:
            expr = s.expr
            if hasattr(expr, "amplitude") and hasattr(expr, "__dataclass_fields__"):
                from dataclasses import replace as _dc_replace

                # factor the amplitude out so the traced callable is the
                # unit pattern and the amplitude rides the params slot
                expr = _dc_replace(expr, amplitude=1.0)
            elif not callable(expr):
                val = float(expr)
                expr = lambda x, t, _v=val: _v * jnp.ones_like(x[0])  # noqa: E731
            gen_quads.append(quad)
            gen_exprs.append(expr)
            gen_slots.append(slot)
    default_amps = jnp.asarray(
        [
            float(s.expr.amplitude) if hasattr(s.expr, "amplitude") else 1.0
            for s in stimuli
        ]
        or [0.0],
        dtype=dtype,
    )
    stim_mat = (
        jnp.stack(stim_loads) if stim_loads else jnp.zeros((1, n), dtype=dtype)
    )
    win_arr = np.asarray(windows if windows else [(0.0, 0.0)], dtype=np.float64)
    win_start = jnp.asarray(win_arr[:, 0], dtype=dtype)
    win_dur = jnp.asarray(win_arr[:, 1], dtype=dtype)
    win_slot_arr = np.asarray(win_slots if win_slots else [0], dtype=np.int64)
    have_windows = bool(stim_loads)

    def b_stim(t, amps, scale):
        # scale * sum_s amp_s * window_s(t) * load_s ; t is not
        # differentiated (window edges are zero-measure).  Inclusive
        # window end, matching TimeWindow.indicator and the fused
        # solver (stimulation.py:104, fused.py:485)
        on = ((t >= win_start) & (t <= win_start + win_dur)).astype(dtype)
        b = (
            scale * jnp.matmul(amps[win_slot_arr] * on, stim_mat, precision=_HIGHEST)
            if have_windows
            else 0.0
        )
        # general expressions (RandomActivation, facet patterns,
        # arbitrary callables): in-trace quadrature assembly
        for j, quad in enumerate(gen_quads):
            b = b + scale * amps[gen_slots[j]] * quad.assemble_load(
                gen_exprs[j], t
            ).astype(dtype)
        if have_windows or gen_quads:
            return b
        return jnp.zeros((n,), dtype=dtype)

    return default_amps, max(len(stimuli), 1), b_stim


def _checkpointed_scan(step, init, ts, checkpoint_segments):
    """``lax.scan`` of a ``jax.checkpoint``-ed step, optionally nested
    into ``K = checkpoint_segments`` checkpointed segments of
    ``m = n_steps/K`` steps (two-level treeverse: peak reverse-mode carry
    memory ``(K + m) * carry_bytes`` instead of ``n_steps * carry_bytes``
    at the cost of one extra forward recomputation per segment)."""
    n_steps = int(ts.shape[0])
    if checkpoint_segments and checkpoint_segments > 1:
        K = int(checkpoint_segments)
        if n_steps % K:
            raise ValueError(
                f"checkpoint_segments={K} must divide n_steps={n_steps}"
            )
        m = n_steps // K

        def segment(states, ts_seg):
            return jax.lax.scan(jax.checkpoint(step), states, ts_seg)

        final, traces = jax.lax.scan(
            jax.checkpoint(segment), init, ts.reshape(K, m)
        )
        traces = jax.tree_util.tree_map(
            lambda a: a.reshape(n_steps, *a.shape[2:]), traces
        )
    else:
        final, traces = jax.lax.scan(jax.checkpoint(step), init, ts)
    return final, traces


def build_diff_simulator(
    mesh,
    *,
    ode_fun: Callable,
    init_states: np.ndarray,
    v_index: int,
    I_s=None,
    probe_points,
    dt: float,
    n_steps: int,
    electrode_points=None,
    sigma_b: float = 1.0,
    theta: float = 1.0,
    pde_theta: float = 1.0,
    C_m: float = 1.0,
    chi: float = 1.0,
    stiffness_components=None,
    quadrature_degree: int = 4,
    cg_rtol: float = 1e-10,
    cg_atol: float = 1e-12,
    cg_maxiter: int = 1000,
    dtype=jnp.float64,
    checkpoint_segments: int | None = None,
) -> Callable[[dict], jnp.ndarray]:
    """Build ``simulate(params) -> probe voltages [n_steps, n_probes]``.

    With ``electrode_points``, ``simulate`` instead returns
    ``{"probes": [n_steps, n_probes], "ecg": [n_steps, n_electrodes]}``:
    each step additionally recovers ``Im = -(1/C_m) Mass^{-1} K(g) v``
    through a second implicit-diff CG and evaluates the pseudo-ECG
    electrode potentials (``ecg.ECGRecovery`` weights) — so ECG-trace
    losses differentiate w.r.t. the same parameters, the inverse problem
    clinical personalization actually poses.

    ``params`` keys (all optional, all differentiable):

    * ``"g"`` — conductivity scaling: scalar (applied to the unit
      isotropic stiffness) or vector ``[len(stiffness_components)]``
      combining pre-assembled components.
    * ``"ionic"`` — the ionic model's ``parameters`` vector.
    * ``"stim_amplitude"`` — stimulus amplitude(s), scalar or
      ``[n_stimuli]``: TimeWindow (separable precomputed load),
      RandomActivation and other amplitude-carrying expressions
      (in-trace quadrature assembly), cell or facet measures.

    ``stiffness_components``: optional list of conductivity specs (each
    accepted by :func:`fem.assemble_mass_stiffness_auto`); assembled once
    with unit scaling and combined in-trace as ``K(g) = sum_i g_i K_i``.
    Default: one isotropic unit component.

    Splitting is the reference's theta choreography (``theta=1`` Godunov,
    ``theta=0.5`` Strang — ``monodomain_solver.py:53-116`` there); the
    PDE stage is the ``pde_theta`` rule of ``base_model.py:83-96``.  Each
    step is ``jax.checkpoint``-ed so reverse-mode memory stays O(1) in
    ``n_steps`` per checkpoint segment.

    ``checkpoint_segments``: two-level (nested) gradient checkpointing
    for long horizons.  The flat per-step scheme still stores every
    step's carry (the scan saves its inputs), so a full beat at
    production scale (20k steps x 442k nodes x 19 TP06 states, f32 =
    672 GB of carries) cannot fit HBM.  With ``K = checkpoint_segments``
    the loop becomes a checkpointed scan of K segments of
    ``m = n_steps/K`` checkpointed steps: peak carry memory drops to
    ``(K + m) * carry_bytes`` (minimized near ``K = sqrt(n_steps)``) at
    the cost of ONE extra forward recomputation of each segment —
    the classic treeverse tradeoff.  ``n_steps`` must divide evenly.

    ``cg_atol`` is relative to ``max|b|`` of each solve, not absolute:
    the implicit CG normalizes its right-hand side (see
    :func:`cg_implicit`, whose ``atol_scaled`` this feeds)."""
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    specs = stiffness_components if stiffness_components is not None else [1.0]
    mass, kvals_stack, ktail_stack = _stack_components(V, specs, dtype)
    has_tail = ktail_stack is not None
    mvals = jnp.asarray(mass.vals, dtype=dtype)
    mtail = jnp.asarray(mass.tail_vals, dtype=dtype) if has_tail else None

    default_amps, n_slots, b_stim_tables = _stimulus_setup(
        V, I_s, quadrature_degree, dtype, n
    )

    probe_dofs, probe_w = fem.point_evaluation_tables(V, np.asarray(probe_points))
    probe_dofs = jnp.asarray(probe_dofs)
    probe_w = jnp.asarray(probe_w, dtype=dtype)

    W_e = None
    if electrode_points is not None:
        # standalone weight computation: no ECGRecovery construction (its
        # __post_init__ would redo the operator assembly done above)
        from .ecg import electrode_weight_matrix

        W_e = jnp.asarray(
            np.asarray(
                electrode_weight_matrix(V, np.asarray(electrode_points), sigma_b=sigma_b)
            ),
            dtype=dtype,
        )  # [ne, n]

    states0 = jnp.asarray(np.asarray(init_states, dtype=np.float64), dtype=dtype)
    if states0.ndim == 1:
        states0 = jnp.tile(states0[:, None], (1, n))

    th = float(pde_theta)
    dt_f = float(dt)
    strang = abs(theta - 0.5) < 1e-12

    def _operator_vals(g):
        g = jnp.atleast_1d(jnp.asarray(g, dtype=dtype))
        kv = jnp.tensordot(g, kvals_stack, axes=1, precision=_HIGHEST)
        kt = (
            jnp.tensordot(g, ktail_stack, axes=1, precision=_HIGHEST)
            if has_tail
            else None
        )
        return mvals, kv, kt

    def _with_values(vals, tail_vals):
        if has_tail:
            return mass.with_values(vals, tail_vals)
        return mass.with_values(vals)

    def simulate(
        params: dict,
        *,
        states0_in=None,
        t0=0.0,
        return_final: bool = False,
    ) -> jnp.ndarray:
        g = params.get("g", 1.0)
        ionic = params.get("ionic", None)
        amps = jnp.atleast_1d(
            jnp.asarray(params.get("stim_amplitude", default_amps), dtype=dtype)
        )
        # a scalar amplitude applies to every stimulus slot
        amps = jnp.broadcast_to(amps, (n_slots,))
        mv, kv, kt = _operator_vals(g)
        A = _with_values(
            chi * C_m * mv + th * dt_f * kv,
            chi * C_m * mtail + th * dt_f * kt if has_tail else None,
        )
        Mop = _with_values(mv, mtail)
        Kop = _with_values(kv, kt)
        Amv = lambda u: A @ u  # noqa: E731
        Mmv = lambda u: Mop @ u  # noqa: E731
        Kmv = lambda u: Kop @ u  # noqa: E731
        diagA = A.diagonal()
        diagM = Mop.diagonal() if W_e is not None else None


        def b_stim(t):
            return b_stim_tables(t, amps, chi)

        def ionic_step(states, t, sub_dt):
            return ode_fun(states, t, ionic, sub_dt)

        def pde_step(v, t):
            # stimulus evaluated at the PDE theta point, matching the
            # production solvers (fused.py:627, reference base_model.py:219)
            rhs = (
                chi * C_m * Mmv(v)
                - (1.0 - th) * dt_f * Kmv(v)
                + dt_f * b_stim(t + th * dt_f)
            )
            return cg_implicit(
                Amv,
                rhs,
                x0=v,
                precond_diag=diagA,
                rtol=cg_rtol,
                atol_scaled=cg_atol,
                maxiter=cg_maxiter,
            )

        def step(states, t):
            # reference splitting choreography (monodomain_solver.py:53-116)
            if strang:
                states = ionic_step(states, t, 0.5 * dt_f)
                v = pde_step(states[v_index], t)
                states = states.at[v_index].set(v)
                states = ionic_step(states, t + 0.5 * dt_f, 0.5 * dt_f)
            else:
                states = ionic_step(states, t, dt_f)
                v = pde_step(states[v_index], t)
                states = states.at[v_index].set(v)
            probe_v = (states[v_index][probe_dofs] * probe_w).sum(axis=1)
            if W_e is None:
                return states, probe_v
            # pseudo-ECG: Im = -(1/C_m) Mass^{-1} K(g) v, phi = W Im
            vv = states[v_index]
            im = cg_implicit(
                Mmv,
                Kmv(vv),
                precond_diag=diagM,
                rtol=cg_rtol,
                atol_scaled=cg_atol,
                maxiter=cg_maxiter,
            ) * (-1.0 / C_m)
            return states, (probe_v, jnp.matmul(W_e, im, precision=_HIGHEST))

        init = states0 if states0_in is None else states0_in
        ts = t0 + jnp.arange(n_steps, dtype=dtype) * dt_f
        final, traces = _checkpointed_scan(step, init, ts, checkpoint_segments)
        out = traces if W_e is None else {"probes": traces[0], "ecg": traces[1]}
        if return_final:
            return out, final
        return out

    return simulate


def build_diff_bidomain_simulator(
    mesh,
    *,
    ode_fun: Callable,
    init_states: np.ndarray,
    v_index: int,
    I_s=None,
    probe_points,
    u_probe_points=None,
    dt: float,
    n_steps: int,
    theta: float = 1.0,
    pde_theta: float = 0.5,
    C_m: float = 1.0,
    intra_components=None,
    extra_components=None,
    quadrature_degree: int = 4,
    cg_rtol: float = 1e-10,
    cg_atol: float = 1e-12,
    cg_maxiter: int = 1000,
    dtype=jnp.float64,
    checkpoint_segments: int | None = None,
) -> Callable[[dict], jnp.ndarray]:
    """Differentiable BIDOMAIN simulation: the two-potential counterpart
    of :func:`build_diff_simulator` (block discretization, deflation and
    theta choreography of :class:`~fenicsx_beat_tpu.bidomain.
    BidomainSolver` — see that module's docstring for the weak form; the
    reference is monodomain-only, so neither the model nor its adjoint
    exist there).

    ``simulate(params) -> v probe traces [n_steps, n_probes]``, or, with
    ``u_probe_points``, ``{"v": ..., "u_e": [n_steps, n_u_probes]}`` —
    the extracellular potential at electrode sites is the signal plunge/
    contact electrodes actually record, so u_e-trace losses pose the
    genuinely bidomain inverse problem (anisotropy-ratio fitting) that
    no monodomain pseudo-ECG can express.  ``u_e`` is grounded to zero
    mesh-mean each step (the solver's convention), so probe values are
    relative to the mesh mean.

    ``params`` keys (all optional, all differentiable):

    * ``"gi"`` / ``"ge"`` — intra-/extracellular conductivity scalings:
      scalars (unit isotropic stiffness) or vectors combining the
      pre-assembled ``intra_components`` / ``extra_components`` (each
      spec accepted by :func:`fem.assemble_mass_stiffness_auto`) as
      ``K_i(gi) = sum_j gi_j K_{i,j}`` — per-region scales or
      fiber/transverse components.
    * ``"ionic"`` — the ionic model's ``parameters`` vector.
    * ``"stim_amplitude"`` — stimulus amplitude(s): TimeWindow,
      RandomActivation, facet (``ds``) stimuli, like the monodomain path.

    The block solve rides the same implicit-diff CG
    (:func:`cg_implicit`): the operator is symmetric positive
    SEMIdefinite (nullspace = constant u_e), handled by the solver's
    deflation — the projection is linear and symmetric, so
    ``custom_linear_solve``'s adjoint solve reuses it unchanged and
    gradients are exact on the grounded quotient space (FD-gated in
    ``tests/test_adjoint_bidomain.py``).  Memory over long horizons:
    same flat/nested ``checkpoint_segments`` scheme, and the simulator
    exposes the ``states0_in``/``t0``/``return_final`` contract, so
    :func:`host_segmented_value_and_grad` (with ``states0 = (states,
    u_e)``) covers full-beat bidomain fits too.

    ``cg_atol`` is relative to ``max|b|`` of each solve, not absolute
    (see :func:`cg_implicit`, whose ``atol_scaled`` this feeds)."""
    if not 0.0 < theta <= 1.0:
        raise ValueError(f"splitting theta must lie in (0, 1], got {theta}")
    if not 0.0 < pde_theta <= 1.0:
        raise ValueError(f"pde_theta must lie in (0, 1], got {pde_theta}")
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    mass, ki_stack, ki_tail_stack = _stack_components(
        V, intra_components if intra_components is not None else [1.0], dtype
    )
    _, ke_stack, ke_tail_stack = _stack_components(
        V, extra_components if extra_components is not None else [1.0], dtype,
        mass=mass,
    )
    has_tail = ki_tail_stack is not None
    mvals = jnp.asarray(mass.vals, dtype=dtype)
    mtail = jnp.asarray(mass.tail_vals, dtype=dtype) if has_tail else None

    default_amps, n_slots, b_stim_tables = _stimulus_setup(
        V, I_s, quadrature_degree, dtype, n
    )

    probe_dofs, probe_w = fem.point_evaluation_tables(V, np.asarray(probe_points))
    probe_dofs = jnp.asarray(probe_dofs)
    probe_w = jnp.asarray(probe_w, dtype=dtype)
    u_dofs = u_w = None
    if u_probe_points is not None:
        u_dofs, u_w = fem.point_evaluation_tables(V, np.asarray(u_probe_points))
        u_dofs = jnp.asarray(u_dofs)
        u_w = jnp.asarray(u_w, dtype=dtype)

    states0 = jnp.asarray(np.asarray(init_states, dtype=np.float64), dtype=dtype)
    if states0.ndim == 1:
        states0 = jnp.tile(states0[:, None], (1, n))
    u0 = jnp.zeros((n,), dtype=dtype)

    th = float(pde_theta)
    th_s = float(theta)
    godunov = abs(th_s - 1.0) < 1e-12
    dt_f = float(dt)

    def _combine(g, stack, tail_stack):
        g = jnp.atleast_1d(jnp.asarray(g, dtype=dtype))
        kv = jnp.tensordot(g, stack, axes=1, precision=_HIGHEST)
        kt = (
            jnp.tensordot(g, tail_stack, axes=1, precision=_HIGHEST)
            if has_tail
            else None
        )
        return kv, kt

    def _with_values(vals, tail_vals):
        if has_tail:
            return mass.with_values(vals, tail_vals)
        return mass.with_values(vals)

    def simulate(
        params: dict,
        *,
        states0_in=None,
        t0=0.0,
        return_final: bool = False,
    ) -> jnp.ndarray:
        gi = params.get("gi", 1.0)
        ge = params.get("ge", 1.0)
        ionic = params.get("ionic", None)
        amps = jnp.atleast_1d(
            jnp.asarray(params.get("stim_amplitude", default_amps), dtype=dtype)
        )
        amps = jnp.broadcast_to(amps, (n_slots,))
        kiv, kit = _combine(gi, ki_stack, ki_tail_stack)
        kev, ket = _combine(ge, ke_stack, ke_tail_stack)
        Ki = _with_values(kiv, kit)
        Kie = _with_values(kiv + kev, kit + ket if has_tail else None)
        A = _with_values(
            C_m * mvals + th * dt_f * kiv,
            C_m * mtail + th * dt_f * kit if has_tail else None,
        )
        Mop = _with_values(mvals, mtail)
        diag = jnp.stack([A.diagonal(), (dt_f / th) * Kie.diagonal()])

        def deflate(x):
            # remove the constant-u_e nullspace component (the solver's
            # f32 lesson, bidomain.py: rounding feeds the nullspace and
            # the Krylov basis loses orthogonality); the projection is
            # linear + symmetric, so it is exactly the operator
            # custom_linear_solve differentiates
            return x.at[1].add(-jnp.mean(x[1]))

        def block_matvec(x):
            x = deflate(x)
            xv, xu = x[0], x[1]
            yv = A @ xv + dt_f * (Ki @ xu)
            yu = dt_f * (Ki @ xv) + (dt_f / th) * (Kie @ xu)
            return deflate(jnp.stack([yv, yu]))

        def pde_step(v, u_e, t):
            # stimulus evaluated at the PDE theta point, matching the
            # production solvers (bidomain.py one_step, fused.py:627)
            rhs_v = (
                C_m * (Mop @ v)
                - (1.0 - th) * dt_f * (Ki @ v)
                + dt_f * b_stim_tables(t + th * dt_f, amps, 1.0)
            )
            rhs_u = -(dt_f / th) * (1.0 - th) * (Ki @ v)
            b = deflate(jnp.stack([rhs_v, rhs_u]))
            x = cg_implicit(
                block_matvec,
                b,
                x0=deflate(jnp.stack([v, u_e])),
                precond_diag=diag,
                rtol=cg_rtol,
                atol_scaled=cg_atol,
                maxiter=cg_maxiter,
            )
            return x[0], x[1] - jnp.mean(x[1])

        def step(carry, t):
            # the solver's general theta choreography (bidomain.py
            # one_step; reference monodomain_solver.py:53-116): tentative
            # theta*dt ionic step, block PDE solve over dt, corrective
            # (1-theta)*dt ionic step
            states, u_e = carry
            states = ode_fun(states, t, ionic, th_s * dt_f)
            v, u_e = pde_step(states[v_index], u_e, t)
            states = states.at[v_index].set(v)
            if not godunov:
                states = ode_fun(states, t + th_s * dt_f, ionic, (1.0 - th_s) * dt_f)
            probe_v = (states[v_index][probe_dofs] * probe_w).sum(axis=1)
            if u_dofs is None:
                return (states, u_e), probe_v
            probe_u = (u_e[u_dofs] * u_w).sum(axis=1)
            return (states, u_e), (probe_v, probe_u)

        init = (states0, u0) if states0_in is None else states0_in
        ts = t0 + jnp.arange(n_steps, dtype=dtype) * dt_f
        final, traces = _checkpointed_scan(step, init, ts, checkpoint_segments)
        out = traces if u_dofs is None else {"v": traces[0], "u_e": traces[1]}
        if return_final:
            return out, final
        return out

    return simulate


def host_segmented_value_and_grad(
    sim: Callable,
    params: dict,
    seg_loss: Callable,
    seg_aux: list,
    *,
    segment_ms: float,
    states0,
    truncate_every: int | None = None,
    carry_clip: float | None = None,
    cotangent_scale: float = 1.0,
    window_outlier: float | None = None,
    window_grads_out: list | None = None,
):
    """``(value, grads)`` of ``sum_k seg_loss(sim_segment_k, seg_aux[k])``
    with the horizon split into HOST-CHAINED segments: one device
    dispatch per segment forward, one per segment backward.

    Why this exists: a full clinical beat (20k steps) as ONE
    ``value_and_grad`` dispatch is a single device program running for
    minutes, which forfeits progress monitoring and bounds nothing if
    the device program fails part-way.  Here the treeverse
    recursion's OUTER level runs on host: the forward pass stores the K
    segment-boundary states (device-resident, ``K * state_bytes`` HBM);
    the backward pass re-runs each segment under ``value_and_grad`` of
    the augmented objective ``seg_loss + <cotangent, final_state>`` —
    the standard adjoint chaining, mathematically identical to the
    monolithic gradient (equality-gated in ``tests/test_adjoint.py``).

    ``sim``: a simulator from :func:`build_diff_simulator` built with
    ``n_steps = segment_steps`` (use ``checkpoint_segments`` inside it
    for per-segment memory).  ``seg_loss(traces, aux) -> scalar`` must
    use only the segment's own traces (sum-decomposable losses: MSE and
    friends); ``seg_aux`` is one pytree per segment (e.g. the target
    slice), all with identical shapes so the two compiled programs are
    reused across every segment.

    ``truncate_every``: truncated backpropagation-through-time over
    windows of that many segments — the state cotangent is zeroed at
    every window boundary, so a segment's loss backpropagates through at
    most ``truncate_every`` segments of dynamics.  This is the standard
    remedy for chaotic gradient blow-up over long cardiac horizons (the
    exact full-beat TP06 adjoint can be finite over a few hundred steps
    and overflow over a full beat): the returned gradient is EXACT for the
    windowed objective in which each window starts from a
    ``stop_gradient`` boundary state (equality-gated in
    ``tests/test_adjoint.py``), which is what clinical windowed fits
    optimize.  ``None`` (default) chains cotangents through the whole
    horizon — the exact monolithic gradient.

    ``carry_clip``: norm-clip the chained state cotangent between
    segments — if ``max|d_state| > carry_clip`` the whole carry pytree
    is rescaled by ``carry_clip / max|d_state|`` (Chebyshev norm: no
    squaring, so the test itself cannot overflow in f32).  Clipped BPTT
    is the standard stabilizer when even one truncation window overflows
    f32: the TP06 plateau sensitivity grows by many decades per 10 ms
    segment, so a window over a few segments can overflow; clipping bounds the carry entering every
    backward segment while preserving its direction.  The result is a
    descent-direction surrogate (biased where clipping engages, exact
    where it does not — gated both ways in ``tests/test_adjoint.py``).
    A carry that is already non-finite (a segment's VJP overflowed
    internally) resets to zero rather than poisoning every earlier
    segment.  Composes with ``truncate_every``.

    ``window_outlier``: trimmed aggregation across truncation windows.
    The stiff TP06 gating makes the VJP through a window grow by many
    decades per 10 ms of PLATEAU dynamics, so on long horizons a single
    window's gradient can dwarf every other window's physical scale —
    one chaotic window then dominates the sum and corrupts its DIRECTION
    (its cosine with the finite-difference gradient of the true
    objective collapses; ``benchmarks.fit_scale fdcheck`` measures it).  With
    ``window_outlier=tau``, per-window gradients whose Chebyshev norm
    exceeds ``tau * median(window norms)`` are DROPPED from the sum —
    the returned gradient is the exact windowed gradient of the
    objective restricted to the well-conditioned windows of this
    iterate (the analogue of loss-spike gradient skipping in large
    -scale training).  Because the cut is at the median, at least half
    the windows always survive.  Requires ``truncate_every``; needs >= 3
    windows to engage.

    ``window_grads_out``: debugging hook — pass a list and it receives
    ``(segment_index, grad_pytree_as_float64_numpy)`` per window (the
    UNFILTERED per-window gradients, already unscaled by
    ``cotangent_scale``), ordered from the last window backwards.

    ``cotangent_scale``: backpropagate with the loss cotangent seeded at
    ``scale`` instead of ``1`` and divide each segment's parameter
    gradient back by ``scale`` — the adjoint-side form of
    mixed-precision loss scaling.  The VJP is LINEAR in its seed, so for
    a power-of-two scale the result is bit-identical mathematics that
    shifts every intermediate cotangent by a constant factor: the f32
    TP06 plateau adjoint can overflow INSIDE a single 10 ms segment even
    with a zero incoming carry, and a scale like ``2**-64 ~ 5.4e-20`` moves
    that whole backward pass out of overflow range while components
    within ~19 decades of the largest stay representable (f32 only
    resolves 7 anyway).  Equality-gated bitwise on a power-of-two scale
    in ``tests/test_adjoint.py``.  ``carry_clip`` is interpreted in the
    TRUE (unscaled) cotangent space regardless.
    """
    n_seg = len(seg_aux)
    if truncate_every is not None and truncate_every < 1:
        raise ValueError(f"truncate_every={truncate_every} must be >= 1")
    if carry_clip is not None and not carry_clip > 0.0:
        raise ValueError(f"carry_clip={carry_clip} must be > 0")
    cs = float(cotangent_scale)
    if not (cs > 0.0 and np.isfinite(cs)):
        raise ValueError(f"cotangent_scale={cotangent_scale} must be finite > 0")

    def _clip_carry(d):
        # carry_clip is specified in TRUE cotangent space; the carry we
        # hold is scaled by cs, so the threshold scales with it
        clip_at = carry_clip * cs
        leaves = jax.tree_util.tree_leaves(d)
        m = jnp.max(jnp.stack([jnp.max(jnp.abs(leaf)) for leaf in leaves]))
        finite = jnp.isfinite(m)
        scale = jnp.where(
            finite, jnp.minimum(1.0, clip_at / jnp.maximum(m, 1e-30)), 0.0
        )
        # Zero non-finite entries explicitly: IEEE Inf*0 = NaN, so a bare
        # ``leaf * scale`` would propagate the overflow this reset exists
        # to contain.  Finite entries are untouched by the
        # where (scale handles them); Inf/NaN entries become exactly 0.
        return jax.tree_util.tree_map(
            lambda leaf: jnp.where(jnp.isfinite(leaf), leaf, 0.0) * scale, d
        )

    clip_fn = jax.jit(_clip_carry) if carry_clip is not None else None

    def seg_fwd(p, s, t0):
        return sim(p, states0_in=s, t0=t0, return_final=True)

    fwd = jax.jit(seg_fwd)

    @jax.jit
    def seg_vg(p, s, t0, aux, d_final):
        def aug(p_, s_):
            traces, fin = seg_fwd(p_, s_, t0)
            carry_term = sum(
                jnp.vdot(a, b)
                for a, b in zip(
                    jax.tree_util.tree_leaves(d_final),
                    jax.tree_util.tree_leaves(fin),
                )
            )
            # the whole backward pass runs in cs-scaled cotangent space
            # (d_final is already scaled); grads are unscaled once, at
            # the end of the sweep
            return cs * seg_loss(traces, aux) + carry_term

        return jax.value_and_grad(aug, argnums=(0, 1))(p, s)

    # forward sweep: boundary states stay on device
    bounds = [states0]
    s = states0
    value = 0.0
    for k in range(n_seg):
        traces, s = fwd(params, s, jnp.asarray(k * segment_ms))
        value += float(seg_loss(traces, seg_aux[k]))
        if k + 1 < n_seg:
            bounds.append(s)

    if window_outlier is not None:
        if not window_outlier > 0.0:
            raise ValueError(f"window_outlier={window_outlier} must be > 0")
        if truncate_every is None:
            raise ValueError("window_outlier requires truncate_every")
    collect = window_grads_out is not None or window_outlier is not None

    # backward sweep: chain cotangents through the boundary states
    d_state = jax.tree_util.tree_map(jnp.zeros_like, states0)
    grads = None
    win_list: list = []  # (segment_index, summed dp) per window
    win_acc = None  # running sum of dp inside the current window
    for k in reversed(range(n_seg)):
        _aug_val, (dp, d_state) = seg_vg(
            params, bounds[k], jnp.asarray(k * segment_ms), seg_aux[k], d_state
        )
        if collect:
            win_acc = dp if win_acc is None else jax.tree_util.tree_map(
                jnp.add, win_acc, dp
            )
        else:
            grads = dp if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, dp
            )
        if truncate_every is not None and k % truncate_every == 0:
            # window boundary: the window [k, k+truncate_every) started
            # from a stop_gradient state — do not chain into segment k-1
            d_state = jax.tree_util.tree_map(jnp.zeros_like, d_state)
            if collect:
                win_list.append((k, win_acc))
                win_acc = None
        elif clip_fn is not None:
            d_state = clip_fn(d_state)
    if collect and win_acc is not None:
        win_list.append((0, win_acc))

    if collect:
        if window_grads_out is not None:
            for k, w in win_list:
                window_grads_out.append(
                    (k, jax.tree_util.tree_map(
                        lambda g: np.asarray(g, np.float64) / cs, w
                    ))
                )
        keep = win_list
        if window_outlier is not None and len(win_list) >= 3:
            norms = np.array([
                max(
                    float(jnp.max(jnp.abs(leaf)))
                    for leaf in jax.tree_util.tree_leaves(w)
                )
                for _, w in win_list
            ])
            # non-finite window sums always count as outliers; the
            # median over finite norms keeps the cut meaningful
            finite = norms[np.isfinite(norms)]
            cut = window_outlier * (np.median(finite) if finite.size else 0.0)
            keep = [
                wl for wl, m in zip(win_list, norms)
                if np.isfinite(m) and m <= cut
            ] or win_list
        for _, w in keep:
            grads = w if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, w
            )
    if cs != 1.0:
        grads = jax.tree_util.tree_map(lambda g: g / cs, grads)
    return value, grads
