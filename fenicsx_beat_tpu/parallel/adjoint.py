"""Sharded differentiable monodomain simulation.

``build_sharded_diff_simulator`` is the multi-device counterpart of
:func:`fenicsx_beat_tpu.adjoint.build_diff_simulator`: the whole
checkpointed time loop runs inside ONE ``shard_map`` over a 1-D device
mesh, so ``jax.value_and_grad`` of a trace loss differentiates straight
through it — ``shard_map`` is differentiable, the halo exchange's VJP is
the reverse ``ppermute``, the CG's implicit adjoint
(:func:`~fenicsx_beat_tpu.adjoint.cg_implicit` /
``lax.custom_linear_solve``) re-runs the same collective-aware solver,
and replicated parameter cotangents are ``psum``-reduced by the
``shard_map`` transpose.  Equality against the single-device gradient is
gated in ``tests/test_adjoint.py``.

Scope: banded STENCIL operators (structured slabs — the production
dx=0.1 Niederer geometry) and separable ``TimeWindow`` stimuli; the
differentiable-parameter surface matches the single-device simulator
(``g`` stiffness-component weights, ``ionic`` parameter vector,
``stim_amplitude``).  Unstructured sharded differentiation falls back to
the single-device path (`adjoint.build_diff_simulator`).

The reference has no adjoint at all (forward-only demos); this module is
beyond-parity surface.  Sharding design per the repo convention: arrays
carry a leading ``[n_devices]`` axis with ``PartitionSpec(axis)`` and
the body indexes ``[0]`` (``parallel/solver.py`` does the same).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import fem
from ..adjoint import _HIGHEST, _checkpointed_scan, cg_implicit
from ..stimulation import TimeWindow
from .partition import Partition1D, pad_global, partition_stencil

__all__ = ["build_sharded_diff_simulator"]


def _shard_map(f, mesh, in_specs, out_specs):
    from jax import shard_map

    return shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def build_sharded_diff_simulator(
    mesh,
    device_mesh,
    *,
    ode_fun: Callable,
    init_states: np.ndarray,
    v_index: int,
    I_s=None,
    probe_points,
    dt: float,
    n_steps: int,
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
):
    """Build ``simulate(params, states0_in=..., t0=..., return_final=...)``
    -> probe voltages ``[n_steps, n_probes]`` running sharded over
    ``device_mesh`` (a 1-axis ``jax.sharding.Mesh``).

    The returned callable has the same contract as
    :func:`~fenicsx_beat_tpu.adjoint.build_diff_simulator` (so
    :func:`~fenicsx_beat_tpu.adjoint.host_segmented_value_and_grad`
    drives it unchanged) with ONE difference: state arrays are padded to
    the partition size — use ``simulate.states0`` (prebuilt from
    ``init_states``) or pad via ``simulate.part``.
    """
    (axis,) = device_mesh.axis_names
    nd = device_mesh.devices.size
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    specs = stiffness_components if stiffness_components is not None else [1.0]
    mass_st = None
    kvals_parts = []
    for spec in specs:
        st = fem.assemble_mass_stiffness_stencil(V, spec, dtype=dtype)
        if st is None:
            raise NotImplementedError(
                "build_sharded_diff_simulator requires a banded stencil "
                "operator (structured mesh); differentiate unstructured "
                "meshes with adjoint.build_diff_simulator on one device"
            )
        m_i, k_i = st
        if mass_st is None:
            mass_st = m_i
        elif k_i.offsets != mass_st.offsets:
            raise ValueError("stiffness components must share the mass pattern")
        kvals_parts.append(k_i)

    part, vm3 = partition_stencil(mass_st, nd, diag_pad=1.0)
    kv4 = np.stack(
        [partition_stencil(k, nd, diag_pad=0.0)[1] for k in kvals_parts],
        axis=1,
    )  # [nd, n_specs, n_local, K]
    offsets = mass_st.offsets
    k0 = offsets.index(0)
    H, n_local = part.halo, part.n_local

    # --- separable TimeWindow stimulus tables, partitioned -------------
    if I_s is None:
        stimuli = []
    elif hasattr(I_s, "expr"):
        stimuli = [I_s]
    else:
        stimuli = list(I_s)
    loads, win = [], []
    for s in stimuli:
        if not isinstance(s.expr, TimeWindow):
            raise NotImplementedError(
                "sharded diff simulator supports TimeWindow stimuli; "
                "other expressions differentiate on the single-device path"
            )
        ents = s.dz.entities()
        if s.dz.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=quadrature_degree,
                                       dtype=np.float64)
        else:
            quad = fem.facet_quadrature(V, ents, degree=quadrature_degree,
                                        dtype=np.float64)
        loads.append(np.asarray(quad.assemble_load_host()))
        win.append((float(s.expr.start), float(s.expr.duration)))
    n_slots = max(len(stimuli), 1)
    default_amps = jnp.asarray(
        [float(s.expr.amplitude) for s in stimuli] or [0.0], dtype=dtype
    )
    stim_g = np.stack(loads) if loads else np.zeros((1, n))
    stim3 = pad_global(stim_g, part).reshape(
        stim_g.shape[0], nd, n_local
    ).transpose(1, 0, 2)  # [nd, n_slots, n_local]
    win_arr = np.asarray(win or [(0.0, 0.0)], dtype=np.float64)
    win_start = jnp.asarray(win_arr[:, 0], dtype=dtype)
    win_dur = jnp.asarray(win_arr[:, 1], dtype=dtype)

    # --- probe weights, partitioned (dense [n_probes, n_local]: probes
    # are few; a dense local matmul + psum is one fused reduction) ------
    probe_dofs, probe_w = fem.point_evaluation_tables(
        V, np.asarray(probe_points)
    )
    n_probes = probe_dofs.shape[0]
    Wp = np.zeros((n_probes, n))
    np.add.at(Wp, (np.arange(n_probes)[:, None], probe_dofs), probe_w)
    Wp3 = pad_global(Wp, part).reshape(n_probes, nd, n_local).transpose(1, 0, 2)

    # --- initial states, padded (pad nodes replicate column 0: resting)
    init = np.asarray(init_states, dtype=np.float64)
    states_g = np.tile(init[:, None], (1, n)) if init.ndim == 1 else init
    states_pad = np.concatenate(
        [states_g, np.tile(states_g[:, :1], (1, part.n_pad - n))], axis=1
    )

    th = float(pde_theta)
    dt_f = float(dt)
    strang = abs(theta - 0.5) < 1e-12
    fwd_perm = [(i, i + 1) for i in range(nd - 1)]
    bwd_perm = [(i + 1, i) for i in range(nd - 1)]

    sh = lambda spec: NamedSharding(device_mesh, spec)  # noqa: E731
    dev_operands = (
        jax.device_put(jnp.asarray(vm3, dtype=dtype), sh(P(axis))),
        jax.device_put(jnp.asarray(kv4, dtype=dtype), sh(P(axis))),
        jax.device_put(jnp.asarray(stim3, dtype=dtype), sh(P(axis))),
        jax.device_put(jnp.asarray(Wp3, dtype=dtype), sh(P(axis))),
    )
    states0_dev = jax.device_put(
        jnp.asarray(states_pad, dtype=dtype), sh(P(None, axis))
    )

    def halo_extend(x):
        if H == 0 or nd == 1:
            z = jnp.zeros((H,), dtype=x.dtype)
            return jnp.concatenate([z, x, z])
        left = jax.lax.ppermute(x[-H:], axis, fwd_perm)
        right = jax.lax.ppermute(x[:H], axis, bwd_perm)
        return jnp.concatenate([left, x, right])

    def spmv(vals, x):
        x_ext = halo_extend(x)
        y = vals[:, k0] * x
        for k, d in enumerate(offsets):
            if d == 0:
                continue
            y = y + vals[:, k] * jax.lax.dynamic_slice(
                x_ext, (H + d,), (n_local,)
            )
        return y

    def pdot(a, b):
        return jax.lax.psum(jnp.vdot(a, b), axis)

    def pmax_abs(r):
        return jax.lax.pmax(jnp.max(jnp.abs(r)), axis)

    def body(vm3_b, kv4_b, stim3_b, Wp3_b, states_b, g, ionic, amps, t0):
        vm = vm3_b[0]
        # HIGHEST: an f32 contraction may otherwise run in TF32 on the GPU
        kv = jnp.tensordot(
            jnp.atleast_1d(jnp.asarray(g, dtype=dtype)), kv4_b[0], axes=1, precision=_HIGHEST
        )
        stim_loc = stim3_b[0]
        Wp_loc = Wp3_b[0]
        states = states_b  # [S, n_local]: P(None, axis) splits the node axis
        io = None if ionic.shape == (0,) else ionic
        A_vals = chi * C_m * vm + th * dt_f * kv
        diagA = A_vals[:, k0]

        def b_stim(t):
            on = ((t >= win_start) & (t <= win_start + win_dur)).astype(dtype)
            return chi * jnp.matmul(amps * on, stim_loc, precision=_HIGHEST)

        def pde_step(v, t):
            rhs = (
                chi * C_m * spmv(vm, v)
                - (1.0 - th) * dt_f * spmv(kv, v)
                + dt_f * b_stim(t + th * dt_f)
            )
            return cg_implicit(
                lambda u: spmv(A_vals, u),
                rhs,
                x0=v,
                precond_diag=diagA,
                rtol=cg_rtol,
                atol_scaled=cg_atol,
                maxiter=cg_maxiter,
                dot=pdot,
                max_abs=pmax_abs,
            )

        def step(states, t):
            if strang:
                states = ode_fun(states, t, io, 0.5 * dt_f)
                v = pde_step(states[v_index], t)
                states = states.at[v_index].set(v)
                states = ode_fun(states, t + 0.5 * dt_f, io, 0.5 * dt_f)
            else:
                states = ode_fun(states, t, io, dt_f)
                v = pde_step(states[v_index], t)
                states = states.at[v_index].set(v)
            probe_v = jax.lax.psum(jnp.matmul(Wp_loc, states[v_index], precision=_HIGHEST), axis)
            return states, probe_v

        ts = t0 + jnp.arange(n_steps, dtype=dtype) * dt_f
        final, traces = _checkpointed_scan(step, states, ts, checkpoint_segments)
        return traces, final

    mapped = _shard_map(
        body,
        device_mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(None, axis),
                  P(), P(), P(), P()),
        out_specs=(P(), P(None, axis)),
    )

    def simulate(params: dict, *, states0_in=None, t0=0.0,
                 return_final: bool = False):
        g = params.get("g", 1.0)
        ionic = params.get("ionic", None)
        ionic = (
            jnp.zeros((0,), dtype) if ionic is None
            else jnp.asarray(ionic, dtype)
        )
        amps = jnp.broadcast_to(
            jnp.atleast_1d(
                jnp.asarray(params.get("stim_amplitude", default_amps),
                            dtype=dtype)
            ),
            (n_slots,),
        )
        init_s = states0_dev if states0_in is None else states0_in
        traces, final = mapped(
            *dev_operands, init_s, g, ionic, amps,
            jnp.asarray(t0, dtype=dtype),
        )
        if return_final:
            return traces, final
        return traces

    simulate.part = part
    simulate.states0 = states0_dev
    simulate.n_probes = n_probes
    return simulate
