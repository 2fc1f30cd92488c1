"""Bidomain solver gates.

The load-bearing gate is the EXACT monodomain reduction: with
proportional conductivities ``M_e = lam * M_i`` the bidomain equations
collapse to the monodomain equation with ``M = lam/(1+lam) * M_i``
(substitute the second equation into the first), so the bidomain ``v``
must match the monodomain solver step for step to solver tolerance —
validating the block operator, the theta rule, the stimulus coupling and
the splitting choreography all at once.  (No reference counterpart:
fenicsx-beat is monodomain-only.)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu import stimulation
from fenicsx_beat_tpu.bidomain import BidomainSolver
from fenicsx_beat_tpu.fused import FusedMonodomainSolver
from fenicsx_beat_tpu.models import fitzhughnagumo as fhn


def _setup(nx=10):
    mesh = meshmod.create_unit_square(None, nx, nx)
    cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    tags = meshmod.meshtags(mesh, 2, cells, 1)

    def make_stim(amp=30.0, duration=1.0):
        return stimulation.Stimulus(
            expr=stimulation.TimeWindow(amplitude=amp, start=0.0, duration=duration),
            dZ=stimulation.dx(mesh, subdomain_data=tags),
            marker=1,
        )

    return mesh, make_stim


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_proportional_conductivities_reduce_to_monodomain(theta):
    mesh, make_stim = _setup()
    lam = 2.0
    g_i = 0.004
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    common = dict(
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=params,
        v_index=fhn.state_index("v"),
        theta=theta,
        pde_theta=0.5,
    )
    n_steps, dt = 20, 0.1

    bi = BidomainSolver(
        mesh=mesh, M_i=g_i, M_e=lam * g_i, I_s=make_stim(),
        cg_rtol=1e-11, cg_atol=1e-13, **common,
    )
    bi.solve((0.0, n_steps * dt), dt=dt)

    mono = FusedMonodomainSolver(
        mesh=mesh, M=(lam / (1.0 + lam)) * g_i, I_s=make_stim(), **common,
    )
    mono.solve((0.0, n_steps * dt), dt=dt)

    v_bi = np.asarray(bi.v)
    v_mono = np.asarray(mono.v)[: v_bi.size]  # fused may pad the node axis
    # two independent iterative solvers accumulate ~CG-tol error per step;
    # 2e-4 mV over a 125 mV range after 20 steps pins the equivalence
    assert np.abs(v_bi - v_mono).max() < 2e-4
    # u_e tracks -(theta_pde v' + (1-theta_pde) v)/(1+lam) up to a constant
    u = np.asarray(bi.u_e)
    assert abs(u.mean()) < 1e-10  # grounded to zero mean
    # the extracellular field is genuinely nonzero under stimulation
    assert np.abs(u).max() > 1e-4


def test_unequal_anisotropy_differs_from_monodomain():
    """With non-proportional conductivities there is NO monodomain
    equivalent — the bidomain solution must measurably differ (this is
    the physics the model exists for)."""
    mesh, make_stim = _setup()
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    common = dict(
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=params,
        v_index=fhn.state_index("v"),
        theta=1.0,
        pde_theta=0.5,
    )
    Mi = np.diag([0.004, 0.0004])   # fiber along x
    Me = np.diag([0.002, 0.0035])   # classic unequal anisotropy ratios
    bi = BidomainSolver(mesh=mesh, M_i=Mi, M_e=Me, I_s=make_stim(), **common)
    bi.solve((0.0, 2.0), dt=0.1)
    # harmonic-mean style monodomain stand-in
    Meff = np.linalg.inv(np.linalg.inv(Mi) + np.linalg.inv(Me))
    mono = FusedMonodomainSolver(mesh=mesh, M=Meff, I_s=make_stim(), **common)
    mono.solve((0.0, 2.0), dt=0.1)
    v_bi = np.asarray(bi.v)
    v_mono = np.asarray(mono.v)[: v_bi.size]
    assert np.abs(v_bi - v_mono).max() > 0.1  # genuinely different physics
    assert np.isfinite(v_bi).all() and np.abs(np.asarray(bi.u_e)).max() > 1e-4


def test_extracellular_consistency_and_status():
    """The discrete second equation holds at the solution (to CG tol) and
    a starved CG surfaces NOT_CONVERGING."""
    from fenicsx_beat_tpu.base_model import Status

    mesh, make_stim = _setup(nx=8)
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    bi = BidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.006, I_s=make_stim(),
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=params, v_index=fhn.state_index("v"),
        theta=1.0, pde_theta=1.0, cg_rtol=1e-12, cg_atol=1e-14,
    )
    # one step; check eq2: K_i v' + (K_i + K_e) u_e = 0 (theta_pde = 1)
    status = bi.solve((0.0, 0.1), dt=0.1)
    assert status == Status.OK
    r = np.asarray(bi._k_i @ bi.v) + np.asarray(bi._k_ie @ bi.u_e)
    assert np.abs(r).max() < 1e-7

    starved = BidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.006, I_s=make_stim(),
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=params, v_index=fhn.state_index("v"),
        theta=1.0, cg_maxiter=1,
    )
    assert starved.solve((0.0, 0.2), dt=0.1) == Status.NOT_CONVERGING


def test_wave_propagates_with_extracellular_field():
    mesh, make_stim = _setup(nx=16)
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    bi = BidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=make_stim(amp=100.0, duration=2.0),
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=params, v_index=fhn.state_index("v"), theta=0.5,
    )
    seen = []
    bi.solve((0.0, 30.0), dt=0.1, save_freq=100,
             save_callback=lambda t, v, u: seen.append((t, v.max(), np.abs(u).max())))
    assert seen[-1][1] > 0.0          # depolarization happened
    assert max(s[2] for s in seen) > 0.5  # a real extracellular signal


def test_constructor_vocabulary_matches_fused():
    """Bare-callable/scalar I_s and general theta values are accepted like
    FusedMonodomainSolver (review findings: they previously crashed or
    were silently coerced to Godunov)."""
    import jax.numpy as jnp2

    mesh, _ = _setup(nx=6)
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    common = dict(
        mesh=mesh, M_i=0.004, M_e=0.008,
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=params, v_index=fhn.state_index("v"),
    )
    # bare callable stimulus over the whole domain
    bi = BidomainSolver(I_s=lambda x, t: 10.0 * jnp2.ones_like(x[0]), **common)
    assert bi.solve((0.0, 0.2), dt=0.1) is not None
    # general theta (neither Godunov nor Strang) runs the corrective step
    bi2 = BidomainSolver(I_s=None, theta=0.7, **common)
    bi2.solve((0.0, 0.2), dt=0.1)
    with pytest.raises(ValueError):
        BidomainSolver(I_s=None, theta=0.0, **common)
    with pytest.raises(ValueError):
        BidomainSolver(I_s=None, pde_theta=1.5, **common)


def test_facet_stimulus_uses_facet_quadrature():
    """A ds-measure stimulus integrates over boundary facets (previously
    facet indices were silently treated as cell indices)."""
    mesh, _ = _setup(nx=6)
    fdim = mesh.tdim - 1
    facets = mesh.exterior_facets()
    tags = meshmod.meshtags(mesh, fdim, facets, 1)
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=50.0, start=0.0, duration=1.0),
        dZ=stimulation.ds(mesh, subdomain_data=tags),
        marker=1,
    )
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    bi = BidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=params, v_index=fhn.state_index("v"), theta=1.0,
    )
    bi.solve((0.0, 0.5), dt=0.1)
    v = np.asarray(bi.v)
    coords = mesh.coords
    on_b = (np.isclose(coords[:, 0], 0) | np.isclose(coords[:, 0], 1)
            | np.isclose(coords[:, 1], 0) | np.isclose(coords[:, 1], 1))
    # boundary nodes received the surface stimulus; interior lags
    assert v[on_b].mean() > v[~on_b].mean() + 0.5


def test_dct_preconditioner_engages_and_scales():
    """On structured grids the spectral u-block preconditioner engages and
    keeps CG iterations nearly mesh-independent (Jacobi grows O(1/h):
    measured 190/step at 48^2 before, ~12 after)."""
    from fenicsx_beat_tpu.telemetry import PerformanceMonitor

    maxes = {}
    for nx in (16, 48):
        mesh = meshmod.create_unit_square(None, nx, nx)
        cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.25) & (x[1] < 0.25))
        tags = meshmod.meshtags(mesh, 2, cells, 1)
        I_s = stimulation.Stimulus(
            expr=stimulation.TimeWindow(amplitude=120.0, start=0.0, duration=2.0),
            dZ=stimulation.dx(mesh, subdomain_data=tags),
            marker=1,
        )
        iters = []

        class Mon(PerformanceMonitor):
            def record_ksp(self, info):
                iters.append(info.iterations)

        bi = BidomainSolver(
            mesh=mesh, M_i=np.diag([0.004, 0.0004]), M_e=np.diag([0.002, 0.0035]),
            I_s=I_s, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
            parameters=fhn.init_parameter_values(stim_amplitude=0.0),
            v_index=fhn.state_index("v"), theta=0.5, monitor=Mon(),
        )
        assert bi._u_dct  # structured grid detected
        bi.solve((0.0, 1.0), dt=0.1, save_freq=1)
        maxes[nx] = max(iters)
    assert maxes[16] < 40 and maxes[48] < 60
    assert maxes[48] < 3 * maxes[16]  # near-mesh-independent


def test_dct_solver_inverts_model_operator():
    """stencil_dct_solver is the (near-)exact inverse of the constant
    interior stencil: applying operator then solver round-trips interior-
    supported fields."""
    from fenicsx_beat_tpu.ops.sparse import ell_to_stencil
    from fenicsx_beat_tpu.ops.spectral import grid_shape, stencil_dct_solver

    mesh = meshmod.create_unit_square(None, 12, 12)
    assert grid_shape(mesh) == (13, 13)
    V = fem.functionspace(mesh, ("P", 1))
    mass, stiff = fem.assemble_mass_stiffness_auto(V, 1.0)
    st = stiff if hasattr(stiff, "offsets") else ell_to_stencil(stiff)
    # precondition A = mass + stiff (SPD, no nullspace) with the DCT
    # inverse of its own stencil: CG should converge in a handful of its
    A = mass.combine(1.0, st, 1.0)
    solver = stencil_dct_solver(A, mesh)
    assert solver is not None
    from fenicsx_beat_tpu.ops.cg import cg

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(V.ndofs))
    x, info = cg(lambda u: A @ u, b, precond=solver, rtol=1e-10, maxiter=200)
    assert bool(info.converged) and int(info.iterations) <= 25
    np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b), atol=1e-8)


def test_dct_preconditioner_3d_box():
    """grid_shape + the spectral solver engage on 3D structured boxes."""
    from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
    from fenicsx_beat_tpu.ops.spectral import grid_shape
    from fenicsx_beat_tpu.telemetry import PerformanceMonitor

    geo = get_3D_slab_geometry(None, dx=0.5, Lx=4.0, Ly=2.0, Lz=2.0)
    mesh = geo.mesh
    assert grid_shape(mesh) == (9, 5, 5)
    cells = meshmod.locate_entities(mesh, 3, lambda x: x[0] < 1.0)
    tags = meshmod.meshtags(mesh, 3, cells, 1)
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=100.0, start=0.0, duration=1.0),
        dZ=stimulation.dx(mesh, subdomain_data=tags),
        marker=1,
    )
    iters = []

    class Mon(PerformanceMonitor):
        def record_ksp(self, info):
            iters.append(info.iterations)

    bi = BidomainSolver(
        mesh=mesh, M_i=np.diag([0.004, 0.0004, 0.0004]),
        M_e=np.diag([0.002, 0.0035, 0.0035]),
        I_s=I_s, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"), theta=1.0, monitor=Mon(),
    )
    assert bi._u_dct
    from fenicsx_beat_tpu.base_model import Status

    assert bi.solve((0.0, 0.5), dt=0.1, save_freq=1) == Status.OK
    assert max(iters) < 60
    assert np.isfinite(np.asarray(bi.v)).all()


def test_dct_declines_on_heterogeneous_conductivity():
    """Per-cell (scar-like) conductivity breaks the constant-stencil model;
    the spectral preconditioner must decline (fall back to Jacobi) rather
    than mis-precondition globally."""
    mesh, make_stim = _setup(nx=12)
    nc = mesh.num_cells
    mids = mesh.coords[mesh.cells].mean(axis=1)
    scale = np.where((mids[:, 0] > 0.4) & (mids[:, 0] < 0.6), 1e-3, 1.0)
    Mi = scale[:, None, None] * (0.004 * np.eye(2))[None]
    assert Mi.shape == (nc, 2, 2)
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    bi = BidomainSolver(
        mesh=mesh, M_i=Mi, M_e=0.006, I_s=make_stim(),
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=params, v_index=fhn.state_index("v"), theta=1.0,
    )
    assert not bi._u_dct  # declined
    assert bi._u_amg  # ...and the SA-AMG hierarchy took over (round 4)
    from fenicsx_beat_tpu.base_model import Status

    assert bi.solve((0.0, 0.3), dt=0.1) == Status.OK


def _lv_setup(psize_ref=0.8):
    from fenicsx_beat_tpu.conductivities import conductivity_tensor
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry

    geo = get_lv_ellipsoid_geometry(psize_ref=psize_ref)
    mesh = geo.mesh
    # apex stimulus region
    apex_x = mesh.coords[:, 0].min()
    cells = meshmod.locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0)
    tags = meshmod.meshtags(mesh, 3, cells, 1)
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=80.0, start=0.0, duration=1.0),
        dZ=stimulation.dx(mesh, subdomain_data=tags),
        marker=1,
    )
    M_i = conductivity_tensor(0.17 / 1.4, 0.019 / 1.4, geo.f0)
    M_e = conductivity_tensor(0.62 / 1.4, 0.24 / 1.4, geo.f0)
    return mesh, M_i, M_e, I_s


def test_amg_u_precond_on_unstructured_lv():
    """On the unstructured anisotropic LV ellipsoid — exactly where the
    DCT declines and round 3 was iteration-bound — the SA-AMG u-block
    preconditioner engages under 'auto', cuts worst-step CG iterations
    vs Jacobi by >= 2x, and produces the same solution."""
    from fenicsx_beat_tpu.base_model import Status
    from fenicsx_beat_tpu.telemetry import PerformanceMonitor

    mesh, M_i, M_e, I_s = _lv_setup()
    results = {}
    for precond in ("auto", "jacobi"):
        iters = []

        class Mon(PerformanceMonitor):
            def record_ksp(self, info):
                iters.append(info.iterations)

        bi = BidomainSolver(
            mesh=mesh, M_i=M_i, M_e=M_e, I_s=I_s,
            ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
            parameters=fhn.init_parameter_values(stim_amplitude=0.0),
            v_index=fhn.state_index("v"), theta=1.0, monitor=Mon(),
            u_precond=precond, cg_rtol=1e-10, cg_atol=1e-12,
        )
        assert bi._u_amg == (precond == "auto")
        assert not bi._u_dct
        assert bi.solve((0.0, 0.5), dt=0.1, save_freq=1) == Status.OK
        results[precond] = (max(int(i) for i in iters),
                            np.asarray(bi.v), np.asarray(bi.u_e))
    amg_its, v_amg, u_amg = results["auto"]
    jac_its, v_jac, u_jac = results["jacobi"]
    assert amg_its * 2 <= jac_its, f"AMG {amg_its} vs Jacobi {jac_its}"
    # both preconditioners solve the SAME system to the same tight
    # tolerance: the physics must agree
    np.testing.assert_allclose(v_amg, v_jac, rtol=0, atol=5e-5)
    np.testing.assert_allclose(u_amg, u_jac, rtol=0, atol=5e-5)


@pytest.mark.parametrize("scheme", ["monolithic", "gs"])
def test_bidomain_ionic_kernel_interpret_matches_xla(scheme):
    """The bidomain solver's ionic step through the Pallas kernel
    (interpreter on the CPU) reproduces the jnp model through XLA."""
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06

    mesh, make_stim = _setup(nx=6)
    common = dict(
        mesh=mesh, M_i=0.0012, M_e=0.0024,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=make_stim(amp=80.0), theta=0.5, scheme=scheme,
    )
    runs = {}
    for route in ("xla", "interpret"):
        bi = BidomainSolver(ionic_kernel=route, **common)
        assert bi.ionic_route == route
        bi.solve((0.0, 1.0), dt=0.05)
        runs[route] = (np.asarray(bi.states), np.asarray(bi.u_e))
    assert runs["xla"][0][tp06.state_index("V")].max() > -80.0  # stimulated
    for a, b in zip(runs["interpret"], runs["xla"]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)
    # off the GPU the default route is XLA
    assert BidomainSolver(**common).ionic_route == "xla"


def test_u_precond_validation():
    mesh, make_stim = _setup(nx=4)
    kwargs = dict(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=make_stim(),
        ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
    )
    with pytest.raises(ValueError, match="u_precond"):
        BidomainSolver(u_precond="spectral-ish", **kwargs)
    # 'dct' on a mesh where the model declines must raise, not silently
    # fall back: the caller asked for a specific preconditioner
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry

    geo = get_lv_ellipsoid_geometry(psize_ref=1.2)
    kwargs["mesh"] = geo.mesh
    kwargs["I_s"] = None
    with pytest.raises(ValueError, match="structured"):
        BidomainSolver(u_precond="dct", **kwargs)


def _block_reference(mesh, M_i, M_e, states0, theta, n_steps, dt, pde_theta=0.5):
    """SciPy float64 reference of the monolithic bidomain splitting: FHN
    ionic sub-steps, then one direct solve per step of the block system
    (u_e pinned to zero mean by a Lagrange multiplier)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from fenicsx_beat_tpu.conductivities import as_cell_tensors

    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs
    rows, cols, mv, kiv, shape = fem.assemble_mass_stiffness_coo(V, as_cell_tensors(M_i, mesh))
    *_, kev, _ = fem.assemble_mass_stiffness_coo(V, as_cell_tensors(M_e, mesh))
    Mm = sp.csr_matrix((mv, (rows, cols)), shape=shape)
    Ki = sp.csr_matrix((kiv, (rows, cols)), shape=shape)
    Kie = Ki + sp.csr_matrix((kev, (rows, cols)), shape=shape)
    th = pde_theta
    A = Mm + th * dt * Ki
    B = Mm - (1.0 - th) * dt * Ki
    e = sp.csr_matrix(np.concatenate([np.zeros(n), np.ones(n)])[None, :])
    S = sp.bmat([[sp.bmat([[A, dt * Ki], [dt * Ki, (dt / th) * Kie]]), e.T], [e, None]]).tocsc()
    p = fhn.init_parameter_values(stim_amplitude=0.0)
    vi = fhn.state_index("v")
    step = lambda y, t, h: np.array(fhn.forward_euler(jnp.asarray(y), t, p, h))  # noqa: E731
    y = np.array(states0, dtype=np.float64)
    u = np.zeros(n)
    for k in range(n_steps):
        t = k * dt
        y = step(y, t, theta * dt)
        v = y[vi]
        rhs = np.concatenate([B @ v, -(dt / th) * (1.0 - th) * (Ki @ v), [0.0]])
        x = spla.spsolve(S, rhs)
        y[vi], u = x[:n], x[n : 2 * n]
        if theta < 1.0:
            y = step(y, t + theta * dt, (1.0 - theta) * dt)
    return y[vi], u


def _bidomain_vs_reference(mesh, M_i, M_e, theta, atol):
    n = mesh.num_vertices
    states0 = np.tile(fhn.init_state_values()[:, None], (1, n))
    states0[fhn.state_index("v")] = np.linspace(0.0, 1.0, n) ** 2
    n_steps, dt = 5, 0.1
    bi = BidomainSolver(
        mesh=mesh, M_i=M_i, M_e=M_e, I_s=None,
        ode_fun=fhn.forward_euler, init_states=states0,
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"), theta=theta, pde_theta=0.5,
        u_precond="jacobi", cg_rtol=1e-12, cg_atol=1e-14,
    )
    bi.solve((0.0, n_steps * dt), dt=dt)
    v_ref, u_ref = _block_reference(mesh, M_i, M_e, states0, theta, n_steps, dt)
    np.testing.assert_allclose(np.asarray(bi.v), v_ref, rtol=0, atol=atol)
    np.testing.assert_allclose(np.asarray(bi.u_e), u_ref - u_ref.mean(), rtol=0, atol=atol)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_bidomain_matches_scipy_block_solve(theta):
    """The monolithic bidomain step (deflated block PCG on the stacked
    [2, n] vector, theta splitting around FHN) equals a direct SciPy solve
    of the same block system on a structured grid."""
    mesh, _ = _setup(nx=8)
    _bidomain_vs_reference(mesh, 0.004, 0.008, theta, atol=1e-9)


def test_bidomain_unstructured_matches_scipy_block_solve():
    """The same reference check on the unstructured LV ellipsoid (ELL +
    apex-tail operators, anisotropic fiber conductivities)."""
    mesh, M_i, M_e, _ = _lv_setup(psize_ref=1.2)
    _bidomain_vs_reference(mesh, M_i, M_e, 1.0, atol=1e-8)

@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_gs_scheme_matches_monolithic(theta):
    """The Gauss-Seidel decoupled scheme solves the block system's two
    rows sequentially (lagged u_e in the parabolic row); the splitting
    error is O(dt) in the v<->u_e coupling, so at a production dt the
    fields must track the monolithic solution to a fraction of a
    percent (measured 0.03-0.07% rel on the anisotropic slab)."""
    mesh, make_stim = _setup()
    params = fhn.init_parameter_values(stim_amplitude=0.0)
    common = dict(
        mesh=mesh, M_i=0.004, M_e=0.002, I_s=make_stim(),
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=params,
        v_index=fhn.state_index("v"),
        theta=theta,
        pde_theta=0.5,
        cg_rtol=1e-10,
        cg_atol=1e-12,
        dtype=jnp.float64,
    )
    fields = {}
    for scheme in ("monolithic", "gs"):
        bi = BidomainSolver(scheme=scheme, **common)
        bi.solve((0.0, 4.0), dt=0.05)
        fields[scheme] = (np.asarray(bi.v), np.asarray(bi.u_e))
    v0, u0 = fields["monolithic"]
    v1, u1 = fields["gs"]
    assert np.abs(v1 - v0).max() < 5e-3 * np.abs(v0).max()
    assert np.abs(u1 - u0).max() < 5e-3 * np.abs(u0).max()


def test_gs_scheme_validation():
    mesh, make_stim = _setup(4)
    with pytest.raises(ValueError, match="scheme"):
        BidomainSolver(
            mesh=mesh, M_i=0.004, M_e=0.002, I_s=make_stim(),
            ode_fun=fhn.forward_euler,
            init_states=fhn.init_state_values(),
            parameters=fhn.init_parameter_values(),
            v_index=fhn.state_index("v"),
            scheme="jacobi-outer",
        )


def test_gs_loose_u_tolerance_error_bounded():
    """Relaxing the gs elliptic solve to gs_u_rtol=1e-4 must not move the
    fields beyond the scheme's own O(dt^2) coupling-lag error (the basis
    for running the production u_e solve loose)."""
    mesh, make_stim = _setup()
    common = dict(
        mesh=mesh, M_i=0.004, M_e=0.002, I_s=make_stim(),
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
        theta=1.0,
        pde_theta=0.5,
        scheme="gs",
        dtype=jnp.float64,
    )
    tight = BidomainSolver(cg_rtol=1e-11, cg_atol=1e-13, **common)
    tight.solve((0.0, 4.0), dt=0.05)
    loose = BidomainSolver(
        cg_rtol=1e-11, cg_atol=1e-13, gs_u_rtol=1e-4, **common
    )
    loose.solve((0.0, 4.0), dt=0.05)
    v0, u0 = np.asarray(tight.v), np.asarray(tight.u_e)
    v1, u1 = np.asarray(loose.v), np.asarray(loose.u_e)
    assert np.abs(v1 - v0).max() < 2e-3 * np.abs(v0).max()
    assert np.abs(u1 - u0).max() < 5e-3 * np.abs(u0).max()


def test_gs_u_solve_every_error_bounded():
    """u_solve_every=2 halves the elliptic CG traffic by advancing u_e on
    skipped steps with the same O(dt^2) extrapolation the coupling lag
    already uses; the fields must stay within the gs scheme's own
    coupling-lag error of the every-step solution.  The constraint is
    algebraic in v (no time derivative), so the cadence only ages the
    extrapolation base, not the dynamics."""
    mesh, make_stim = _setup()
    common = dict(
        mesh=mesh, M_i=0.004, M_e=0.002, I_s=make_stim(),
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
        theta=1.0,
        pde_theta=0.5,
        scheme="gs",
        cg_rtol=1e-11,
        cg_atol=1e-13,
        dtype=jnp.float64,
    )
    every = BidomainSolver(**common)
    every.solve((0.0, 4.0), dt=0.05)
    v0, u0 = np.asarray(every.v), np.asarray(every.u_e)
    for k, tol in ((2, 2e-3), (4, 8e-3)):
        cad = BidomainSolver(u_solve_every=k, **common)
        cad.solve((0.0, 4.0), dt=0.05)
        v1, u1 = np.asarray(cad.v), np.asarray(cad.u_e)
        assert np.abs(v1 - v0).max() < tol * np.abs(v0).max(), k
        assert np.abs(u1 - u0).max() < 4 * tol * np.abs(u0).max(), k


def test_u_solve_every_validation():
    mesh, make_stim = _setup(4)
    common = dict(
        mesh=mesh, M_i=0.004, M_e=0.002, I_s=make_stim(),
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(),
        v_index=fhn.state_index("v"),
    )
    with pytest.raises(ValueError, match="u_solve_every"):
        BidomainSolver(scheme="monolithic", u_solve_every=2, **common)
    with pytest.raises(ValueError, match="u_solve_every"):
        BidomainSolver(scheme="gs", u_solve_every=0, **common)
