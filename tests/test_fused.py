"""Fused (lax.scan) solver vs the object-oriented splitting solver.

The OO path replicates the reference's host choreography step-by-step;
the fused path must produce the same trajectory (same algorithm, same
operators) for both Godunov and Strang splitting.
"""

import numpy as np
import pytest

import fenicsx_beat_tpu as beat
from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu.fused import FusedMonodomainSolver
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06


def _setup(N=16):
    mesh = meshmod.create_unit_square(None, N, N)
    cells = meshmod.locate_entities(
        mesh, mesh.tdim, lambda x: np.logical_and(x[0] <= 0.3, x[1] <= 0.3)
    )
    tags = meshmod.meshtags(mesh, mesh.tdim, cells, 1)
    dx = beat.stimulation.dx(mesh, subdomain_data=tags)
    expr = beat.stimulation.TimeWindow(amplitude=80.0, start=0.0, duration=2.0)
    I_s = beat.Stimulus(expr=expr, dZ=dx, marker=1)
    return mesh, I_s, dx


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_fused_matches_oo_splitting(theta):
    mesh, I_s, dx = _setup()
    T, dt = 5.0, 0.05
    M = 0.001

    params = tp06.init_parameter_values(stim_amplitude=0.0)
    init = tp06.init_state_values()
    v_index = tp06.state_index("V")

    # object-oriented path (reference choreography)
    time = fem.Constant(0.0)
    pde = beat.MonodomainModel(time=time, mesh=mesh, M=M, I_s=I_s, dx=dx)
    V_ode = fem.functionspace(mesh, ("P", 1))
    ode = beat.odesolver.DolfinODESolver(
        v_ode=fem.Function(V_ode),
        v_pde=pde.state,
        fun=tp06.generalized_rush_larsen,
        init_states=init,
        parameters=params,
        num_states=len(init),
        v_index=v_index,
    )
    oo = beat.MonodomainSplittingSolver(pde=pde, ode=ode, theta=theta)
    oo.solve((0.0, T), dt=dt)
    v_oo = np.array(pde.state.x.array)

    # fused on-device path
    fused = FusedMonodomainSolver(
        mesh=mesh,
        M=M,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=init,
        parameters=params,
        v_index=v_index,
        I_s=I_s,
        theta=theta,
        # match the OO path's direct-solver-equivalent CG tolerances
        params={"ksp_rtol": 1e-13, "ksp_atol": 1e-14},
    )
    fused.solve((0.0, T), dt=dt)
    v_fused = np.asarray(fused.v)

    assert v_oo.max() > 0.0  # the stimulus actually depolarized the corner
    np.testing.assert_allclose(v_fused, v_oo, rtol=1e-6, atol=2e-5)


def test_fused_ionic_kernel_interpret_matches_plain():
    """The single-kernel ionic step (ops/ionic_kernel.py, Pallas
    interpreter on the CPU) reproduces the XLA fused trajectory."""
    mesh, I_s, dx = _setup(N=8)
    common = dict(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=0.5,
    )
    plain = FusedMonodomainSolver(ionic_kernel="xla", **common)
    plain.solve((0.0, 1.0), dt=0.05)
    kernel = FusedMonodomainSolver(ionic_kernel="interpret", **common)
    assert kernel.ionic_route == "interpret"
    kernel.solve((0.0, 1.0), dt=0.05)
    np.testing.assert_allclose(np.asarray(kernel.states), np.asarray(plain.states), rtol=1e-10, atol=1e-10)
    # off the GPU the default route is XLA
    assert FusedMonodomainSolver(**common).ionic_route == "xla"


@pytest.mark.parametrize(
    "platform, route, params_ndim, expected",
    [
        ("gpu", None, 1, "triton"),
        ("cpu", None, 1, "xla"),
        ("gpu", None, 2, "xla"),  # per-node parameters cannot be baked in
        ("gpu", "xla", 1, "xla"),
        ("cpu", "interpret", 1, "interpret"),
    ],
)
def test_select_route(platform, route, params_ndim, expected):
    from fenicsx_beat_tpu.ops.ionic_kernel import select_route

    p = tp06.init_parameter_values()
    params = p if params_ndim == 1 else np.tile(p[:, None], (1, 4))
    assert select_route(tp06.generalized_rush_larsen, params, platform, route) == expected


def test_select_route_rejects_unknown_and_unqualified():
    from fenicsx_beat_tpu.ops.ionic_kernel import select_route

    p = tp06.init_parameter_values()
    with pytest.raises(ValueError, match="ionic_kernel"):
        select_route(tp06.generalized_rush_larsen, p, "gpu", "triton")
    with pytest.raises(ValueError, match="xp"):
        select_route(lambda states, t, parameters, dt: states, p, "cpu", "interpret")


def test_fused_route_follows_the_state_device(monkeypatch):
    """The default route comes from the platform of the device that holds
    the solver's state, not from JAX's default backend: a solver built
    under ``jax.default_device(cpu)`` on a GPU host takes the XLA route."""
    import jax

    from fenicsx_beat_tpu import device

    mesh, I_s, _ = _setup(N=4)
    common = dict(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
    )
    with jax.default_device(jax.devices("cpu")[0]):
        solver = FusedMonodomainSolver(**common)
    assert device.platform_of(solver.states) == "cpu"
    assert solver.ionic_route == "xla"
    seen = []

    def on_gpu(x):
        seen.append(x)
        return "gpu"

    monkeypatch.setattr(device, "platform_of", on_gpu)
    solver = FusedMonodomainSolver(**common)
    assert solver.ionic_route == "triton"
    assert seen and seen[0] is solver.states


def test_fused_tabulated_matches_exact():
    """The table-driven TP06 step (off the main path) stays physically
    close to the exact model on the fused path, within its audited table
    error, and takes the XLA route (it does not follow the row-wise
    ``xp`` convention of the ionic kernel)."""
    mesh, I_s, dx = _setup(N=8)
    dt, theta = 0.05, 1.0
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    tab_fun = tp06.tabulated_rush_larsen(theta * dt, params)
    assert max(tab_fun.table_error.values()) < 1e-2
    common = dict(
        mesh=mesh,
        M=0.001,
        init_states=tp06.init_state_values(),
        parameters=params,
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=theta,
    )
    tab = FusedMonodomainSolver(ode_fun=tab_fun, **common)
    assert tab.ionic_route == "xla"
    with pytest.raises(ValueError, match="xp"):
        FusedMonodomainSolver(ode_fun=tab_fun, ionic_kernel="interpret", **common)
    tab.solve((0.0, 1.0), dt=dt)
    exact = FusedMonodomainSolver(ode_fun=tp06.generalized_rush_larsen, **common)
    exact.solve((0.0, 1.0), dt=dt)
    np.testing.assert_allclose(np.asarray(tab.v), np.asarray(exact.v), atol=0.5)


def test_fused_tabulated_rejects_mismatched_dt():
    """A baked-dt model must refuse a solve whose ionic sub-steps differ."""
    mesh, I_s, dx = _setup(N=4)
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    fused = FusedMonodomainSolver(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.tabulated_rush_larsen(0.05, params),
        init_states=tp06.init_state_values(),
        parameters=params,
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=0.5,  # Strang sub-steps are dt/2 = 0.025, not the baked 0.05
    )
    with pytest.raises(ValueError, match="bakes dt"):
        fused.solve((0.0, 0.1), dt=0.05)


def test_fused_checkpoint_resume(tmp_path):
    """Full-state save/load reproduces an uninterrupted run exactly."""
    mesh, I_s, dx = _setup(N=10)
    common = dict(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
    )
    ref = FusedMonodomainSolver(**common)
    ref.solve((0.0, 4.0), dt=0.05)
    v_ref = np.asarray(ref.v)

    a = FusedMonodomainSolver(**common)
    a.solve((0.0, 2.0), dt=0.05)
    ckpt = a.save_state(tmp_path / "mid", t=2.0)

    b = FusedMonodomainSolver(**common)
    t0 = b.load_state(ckpt)
    assert t0 == 2.0
    b.solve((t0, 4.0), dt=0.05)
    np.testing.assert_allclose(np.asarray(b.v), v_ref, atol=1e-12)


def test_fused_diffusion_matches_scipy_solve():
    """With a reaction-free ionic model each fused step is one theta-rule
    diffusion solve: the on-device CG trajectory matches SciPy's direct
    solve of ``(C_m M + th dt K) v' = (C_m M - (1 - th) dt K) v``."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from fenicsx_beat_tpu.conductivities import as_cell_tensors

    mesh, _, _ = _setup(N=12)
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs
    v0 = np.random.default_rng(3).standard_normal(n)
    dt, th, M = 0.05, 0.5, 0.01
    fused = FusedMonodomainSolver(
        mesh=mesh,
        M=M,
        ode_fun=lambda states, t, parameters, dt: states,
        init_states=v0[None, :],
        parameters=None,
        v_index=0,
        theta=1.0,
        params={"ksp_rtol": 1e-13, "ksp_atol": 1e-15},
    )
    fused.solve((0.0, 10 * dt), dt=dt)

    rows, cols, mv, kv, shape = fem.assemble_mass_stiffness_coo(V, as_cell_tensors(M, mesh))
    Mm = sp.csr_matrix((mv, (rows, cols)), shape=shape)
    K = sp.csr_matrix((kv, (rows, cols)), shape=shape)
    A = (Mm + th * dt * K).tocsc()
    B = Mm - (1.0 - th) * dt * K
    v = v0.copy()
    for _ in range(10):
        v = spla.spsolve(A, B @ v)
    np.testing.assert_allclose(np.asarray(fused.v), v, rtol=1e-9, atol=1e-10)


def test_fused_surfaces_cg_non_convergence():
    """With ksp_max_it=1 the CG cannot meet tolerance; the solver must
    return Status.NOT_CONVERGING and the monitor must see the real stats
    (reference records the KSP converged_reason, telemetry.py:67-76)."""
    from fenicsx_beat_tpu.base_model import Status
    from fenicsx_beat_tpu.telemetry import PerformanceMonitor

    mesh, I_s, dx = _setup(N=8)
    monitor = PerformanceMonitor(log_frequency=0)
    solver = FusedMonodomainSolver(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        monitor=monitor,
        params={"ksp_max_it": 1, "ksp_rtol": 1e-14, "ksp_atol": 1e-16},
    )
    status = solver.solve((0.0, 0.5), dt=0.05)
    assert status == Status.NOT_CONVERGING
    assert solver.last_solve_converged is False
    assert monitor.ksp_last_converged_reason == 0
    assert monitor.ksp_last_residual_norm > 0.0

    # and a healthy solve reports OK with a converged monitor record
    ok_monitor = PerformanceMonitor(log_frequency=0)
    healthy = FusedMonodomainSolver(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        monitor=ok_monitor,
    )
    assert healthy.solve((0.0, 0.5), dt=0.05) == Status.OK
    assert ok_monitor.ksp_last_converged_reason == 1


def test_fused_multi_marker_matches_oo():
    """Two-marker TP06 (different per-region initial states) on the fused
    path must match the OO MonodomainSplittingSolver driving a
    DolfinMultiODESolver (reference odesolver.py:228-354 semantics)."""
    from fenicsx_beat_tpu.odesolver import DolfinMultiODESolver

    mesh, I_s, dx = _setup(N=12)
    T, dt = 2.0, 0.05
    M = 0.001

    params = tp06.init_parameter_values(stim_amplitude=0.0)
    init1 = tp06.init_state_values()
    init2 = tp06.init_state_values(V=-60.0)  # pre-depolarized region
    v_index = tp06.state_index("V")

    V_ode = fem.functionspace(mesh, ("P", 1))
    coords = V_ode.tabulate_dof_coordinates()
    marker_arr = np.where(coords[:, 0] < 0.5, 1, 2)

    # OO path with DolfinMultiODESolver
    time = fem.Constant(0.0)
    pde = beat.MonodomainModel(time=time, mesh=mesh, M=M, I_s=I_s, dx=dx)
    markers_fn = fem.Function(V_ode)
    markers_fn.x.array[:] = marker_arr
    ode = DolfinMultiODESolver(
        v_ode=fem.Function(V_ode),
        v_pde=pde.state,
        markers=markers_fn,
        init_states={1: init1, 2: init2},
        parameters={1: params, 2: params},
        fun={1: tp06.generalized_rush_larsen, 2: tp06.generalized_rush_larsen},
        num_states={1: len(init1), 2: len(init2)},
        v_index={1: v_index, 2: v_index},
    )
    oo = beat.MonodomainSplittingSolver(pde=pde, ode=ode, theta=1.0)
    oo.solve((0.0, T), dt=dt)
    v_oo = np.array(pde.state.x.array)

    # fused path with dict-valued model inputs
    fused = FusedMonodomainSolver(
        mesh=mesh,
        M=M,
        ode_fun={1: tp06.generalized_rush_larsen, 2: tp06.generalized_rush_larsen},
        init_states={1: init1, 2: init2},
        parameters={1: params, 2: params},
        v_index={1: v_index, 2: v_index},
        ode_markers=marker_arr,
        I_s=I_s,
        theta=1.0,
    )
    fused.solve((0.0, T), dt=dt)
    np.testing.assert_allclose(np.asarray(fused.v), v_oo, rtol=1e-6, atol=1e-4)


def test_multi_marker_composition_matches_per_marker_stepping():
    """The masked multi-model composition (odesolver.make_multi_ode) that
    the fused solver steps equals stepping each marker's nodes with its
    own model and parameters (endo vs epi TP06 here)."""
    import jax.numpy as jnp

    from fenicsx_beat_tpu.odesolver import make_multi_ode

    n = 64
    markers = np.where(np.arange(n) % 3 == 0, 1, 2)
    p_epi = tp06.init_parameter_values(stim_amplitude=0.0)
    p_endo = tp06.init_parameter_values(stim_amplitude=0.0, celltype=0.0)
    init = {1: tp06.init_state_values(), 2: tp06.init_state_values(V=-60.0)}
    fun, states, masks, vi = make_multi_ode(
        markers,
        {1: tp06.generalized_rush_larsen, 2: tp06.generalized_rush_larsen},
        init,
        {1: p_epi, 2: p_endo},
        {1: tp06.state_index("V"), 2: tp06.state_index("V")},
        dtype=jnp.float64,
    )
    assert vi == 0  # the composition stores every model's voltage in row 0
    states = jnp.asarray(states)
    per = {m: np.tile(init[m][:, None], (1, int((markers == m).sum()))) for m in (1, 2)}
    for k in range(20):
        states = fun(states, 0.05 * k, jnp.asarray(masks), 0.05)
        for m, p in ((1, p_epi), (2, p_endo)):
            per[m] = np.asarray(tp06.generalized_rush_larsen(per[m], 0.05 * k, p, 0.05))
    # undo the voltage-to-row-0 swap of the composition's storage layout
    swap = np.arange(states.shape[0])
    swap[[0, tp06.state_index("V")]] = [tp06.state_index("V"), 0]
    out = np.asarray(states)[swap]
    for m in (1, 2):
        np.testing.assert_allclose(out[:, markers == m], per[m], rtol=1e-12, atol=1e-12)


def test_merged_strang_matches_unmerged():
    """merge_strang_halves regroups A(dt/2)A(dt/2) interior pairs into
    A(dt): an exact Strang composition per chunk whose only delta vs the
    unmerged choreography is the sub-integrator's (GRL) local step size —
    voltages must agree to a fraction of a millivolt over an activation."""
    mesh, I_s, dx = _setup()
    T, dt = 5.0, 0.05
    common = dict(
        mesh=mesh,
        M=0.001,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=0.5,
    )
    ref = FusedMonodomainSolver(**common)
    ref.solve((0.0, T), dt=dt)
    merged = FusedMonodomainSolver(merge_strang_halves=True, **common)
    merged.solve((0.0, T), dt=dt)

    # pointwise v at a ~300 mV/ms upstroke is hypersensitive to sub-dt
    # front shifts; the physical equivalence metric is activation time
    a_ref, a_merged = ref.activation_times(), merged.activation_times()
    assert ((a_ref >= 0) == (a_merged >= 0)).all()  # same activated set
    both = a_ref >= 0
    assert both.any()
    # midpoint sampling reconstructs the exact Strang observation of the
    # merged trajectory (fused.py one_step), so activation times agree to
    # one dt (the remaining delta is the trajectories' own grouping error)
    assert np.abs(a_ref[both] - a_merged[both]).max() <= dt + 1e-6
    # away from the moving front the voltages agree closely
    settled = both & (a_ref < T - 1.5)
    if settled.any():
        dv = np.abs(np.asarray(ref.v) - np.asarray(merged.v))[settled]
        assert dv.max() < 2.5  # mV on a ~125 mV range

    # ignored (with a warning) when theta != 0.5
    g = FusedMonodomainSolver(**{**common, "theta": 1.0}, merge_strang_halves=True)
    g.solve((0.0, 1.0), dt=dt)


def test_fused_unstructured_lv_matches_oo():
    """On the unstructured LV ellipsoid (ELL + apex tail operators) the
    fused path reproduces the OO MonodomainSplittingSolver."""
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.mesh import meshtags
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu.ops.sparse import ELLMatrix
    from fenicsx_beat_tpu.stimulation import Stimulus, TimeWindow
    from fenicsx_beat_tpu.stimulation import dx as dx_measure

    geo = get_lv_ellipsoid_geometry(psize_ref=0.8)
    mesh = geo.mesh
    tags = meshtags(mesh, 3, np.arange(150, dtype=np.int32), 1)
    dx = dx_measure(mesh, subdomain_data=tags)
    I_s = Stimulus(expr=TimeWindow(amplitude=60.0, start=0.0, duration=1.0), dZ=dx, marker=1)
    M, T, dt = 0.05, 1.0, 0.1
    init = fhn.init_state_values()
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    vi = fhn.state_index("v")

    time = fem.Constant(0.0)
    pde = beat.MonodomainModel(time=time, mesh=mesh, M=M, I_s=I_s, dx=dx)
    ode = beat.odesolver.DolfinODESolver(
        v_ode=fem.Function(fem.functionspace(mesh, ("P", 1))),
        v_pde=pde.state,
        fun=fhn.forward_euler,
        init_states=init,
        parameters=params,
        num_states=len(init),
        v_index=vi,
    )
    beat.MonodomainSplittingSolver(pde=pde, ode=ode, theta=1.0).solve((0.0, T), dt=dt)

    fused = FusedMonodomainSolver(
        mesh=mesh, M=M, ode_fun=fhn.forward_euler, init_states=init,
        parameters=params, v_index=vi, I_s=I_s,
        params={"ksp_rtol": 1e-13, "ksp_atol": 1e-14},
    )
    assert isinstance(fused._mass, ELLMatrix) and fused._mass.has_tail
    fused.solve((0.0, T), dt=dt)
    v_oo = np.array(pde.state.x.array)
    assert np.ptp(v_oo) > 0.1  # the stimulus moved the field
    np.testing.assert_allclose(np.asarray(fused.v), v_oo, rtol=1e-6, atol=1e-6)


