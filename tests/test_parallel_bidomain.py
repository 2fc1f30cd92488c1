"""Sharded bidomain gates (8 virtual CPU devices via conftest).

The load-bearing gate mirrors tests/test_parallel.py's strategy: the
sharded bidomain must reproduce the single-device fused BidomainSolver on
the same problem — on a structured sheet (stencil partition) AND on the
unstructured LV ellipsoid (RCM + hybrid ELL/tail partition + sharded
SA-AMG).  (No reference counterpart: fenicsx-beat is monodomain-only.)
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as DeviceMesh

from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu import stimulation
from fenicsx_beat_tpu.base_model import Status
from fenicsx_beat_tpu.bidomain import BidomainSolver
from fenicsx_beat_tpu.models import fitzhughnagumo as fhn
from fenicsx_beat_tpu.parallel.bidomain import ShardedBidomainSolver
from fenicsx_beat_tpu.telemetry import PerformanceMonitor


def _device_mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices, have {len(devs)}")
    return DeviceMesh(np.array(devs[:n]), ("x",))


def _sheet_setup(nx=20):
    mesh = meshmod.create_unit_square(None, nx, nx)
    cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    tags = meshmod.meshtags(mesh, 2, cells, 1)
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=60.0, start=0.0, duration=1.0),
        dZ=stimulation.dx(mesh, subdomain_data=tags),
        marker=1,
    )
    return mesh, I_s


def _common(theta=0.5):
    return dict(
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
        theta=theta,
        pde_theta=0.5,
        cg_rtol=1e-11,
        cg_atol=1e-13,
    )


class _IterMon(PerformanceMonitor):
    def __init__(self):
        super().__init__()
        self.iters = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_sharded_matches_fused_structured(theta):
    """Structured sheet (stencil partition): sharded-8 == fused, both
    splitting choreographies."""
    mesh, I_s = _sheet_setup()
    kw = _common(theta)
    n_steps, dt = 10, 0.1

    bi = BidomainSolver(mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s, **kw)
    bi.solve((0.0, n_steps * dt), dt=dt)

    sb = ShardedBidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
        device_mesh=_device_mesh(8), **kw,
    )
    assert sb._offsets is not None  # stencil partition engaged
    assert sb.solve((0.0, n_steps * dt), dt=dt) == Status.OK

    np.testing.assert_allclose(np.asarray(sb.v), np.asarray(bi.v), rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        np.asarray(sb.u_e), np.asarray(bi.u_e), rtol=0, atol=2e-6
    )
    assert abs(float(np.asarray(sb.u_e).mean())) < 1e-10


def test_sharded_solve_compiles_one_chunk_program():
    """Chunks after the first reuse its compiled program: the time the
    chunk returns is replicated over the mesh, like the scalars the first
    chunk received."""
    mesh, I_s = _sheet_setup(nx=8)
    sb = ShardedBidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
        device_mesh=_device_mesh(4), **_common(),
    )
    sb.solve((0.0, 0.6), dt=0.1, save_freq=2)
    assert sb._run_chunk_ops._cache_size() == 1


def test_sharded_ionic_kernel_interpret_matches_xla():
    """The sharded bidomain ionic step through the Pallas kernel
    (interpreter on the CPU) reproduces the jnp model through XLA."""
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06

    mesh, I_s = _sheet_setup(nx=8)
    kw = dict(
        _common(),
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
    )
    v = {}
    for route in ("xla", "interpret"):
        sb = ShardedBidomainSolver(
            mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
            device_mesh=_device_mesh(4), ionic_kernel=route, **kw,
        )
        assert sb.ionic_route == route
        sb.solve((0.0, 0.5), dt=0.05)
        v[route] = (np.asarray(sb.v), np.asarray(sb.u_e))
    for a, b in zip(v["interpret"], v["xla"]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


def test_sharded_matches_fused_unstructured_lv():
    """Unstructured LV ellipsoid: RCM + hybrid ELL/tail partition + the
    SHARDED SA-AMG u-block V-cycle reproduce the single-device solution;
    AMG cuts worst-step iterations >= 2x vs the sharded Jacobi run."""
    from fenicsx_beat_tpu.conductivities import conductivity_tensor
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry

    geo = get_lv_ellipsoid_geometry(psize_ref=0.8)
    mesh = geo.mesh
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
    kw = _common(theta=1.0)
    n_steps, dt = 5, 0.1

    bi = BidomainSolver(mesh=mesh, M_i=M_i, M_e=M_e, I_s=I_s, **kw)
    bi.solve((0.0, n_steps * dt), dt=dt)

    results = {}
    for precond in ("auto", "jacobi"):
        mon = _IterMon()
        sb = ShardedBidomainSolver(
            mesh=mesh, M_i=M_i, M_e=M_e, I_s=I_s,
            device_mesh=_device_mesh(8), monitor=mon, u_precond=precond, **kw,
        )
        assert sb._offsets is None and sb._perm is not None  # RCM path
        assert sb._u_amg == (precond == "auto")
        assert sb.solve((0.0, n_steps * dt), dt=dt, save_freq=1) == Status.OK
        results[precond] = (max(mon.iters), np.asarray(sb.v), np.asarray(sb.u_e))
        np.testing.assert_allclose(np.asarray(sb.v), np.asarray(bi.v),
                                   rtol=0, atol=5e-6)
        np.testing.assert_allclose(np.asarray(sb.u_e), np.asarray(bi.u_e),
                                   rtol=0, atol=5e-6)
    amg_its = results["auto"][0]
    jac_its = results["jacobi"][0]
    assert amg_its * 2 <= jac_its, f"AMG {amg_its} vs Jacobi {jac_its}"


def test_sharded_small_mesh_dense_amg():
    """Below coarse_n the sharded AMG path is the replicated dense
    pseudo-inverse (all_gather + matmul): still matches fused."""
    mesh, I_s = _sheet_setup(nx=8)  # 81 dofs << coarse_n
    kw = _common(theta=1.0)
    bi = BidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s, u_precond="jacobi", **kw
    )
    bi.solve((0.0, 0.5), dt=0.1)
    sb = ShardedBidomainSolver(
        mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
        device_mesh=_device_mesh(4), u_precond="amg", **kw,
    )
    assert sb._u_amg and sb._hier is not None and not sb._hier.levels
    assert sb.solve((0.0, 0.5), dt=0.1) == Status.OK
    np.testing.assert_allclose(np.asarray(sb.v), np.asarray(bi.v), rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.asarray(sb.u_e), np.asarray(bi.u_e), rtol=0, atol=2e-6)


def test_sharded_bidomain_validation():
    mesh, I_s = _sheet_setup(nx=6)
    kw = _common()
    with pytest.raises(ValueError, match="u_precond"):
        ShardedBidomainSolver(
            mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
            device_mesh=_device_mesh(2), u_precond="boomer", **kw,
        )
    with pytest.raises(ValueError, match="ode_markers"):
        # dict-valued ode_fun is supported, but needs the marker field
        ShardedBidomainSolver(
            mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
            device_mesh=_device_mesh(2),
            **{**kw, "ode_fun": {1: fhn.forward_euler}},
        )


def test_sharded_multi_marker_matches_single_device():
    """Two-marker TP06 endo/epi split on the sharded bidomain path
    dict-valued ode_fun composes via make_multi_ode with
    node masks sharded along the node axis, and must reproduce the
    single-device BidomainSolver with the same markers."""
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06

    mesh, I_s = _sheet_setup(nx=12)
    V = fem.functionspace(mesh, ("P", 1))
    coords = V.tabulate_dof_coordinates()
    marker_arr = np.where(coords[:, 0] < 0.5, 1, 2)
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    kw = dict(
        mesh=mesh,
        M_i=0.004,
        M_e=0.008,
        I_s=I_s,
        ode_fun={
            1: tp06.generalized_rush_larsen,
            2: tp06.generalized_rush_larsen,
        },
        init_states={
            1: tp06.init_state_values(),
            2: tp06.init_state_values(V=-60.0),
        },
        parameters={1: params, 2: params},
        v_index={1: tp06.state_index("V"), 2: tp06.state_index("V")},
        ode_markers=marker_arr,
        theta=1.0,
        pde_theta=0.5,
        cg_rtol=1e-11,
        cg_atol=1e-13,
    )
    n_steps, dt = 8, 0.05

    bi = BidomainSolver(**kw)
    bi.solve((0.0, n_steps * dt), dt=dt)

    sb = ShardedBidomainSolver(device_mesh=_device_mesh(8), **kw)
    assert sb._params_sharded
    assert sb.solve((0.0, n_steps * dt), dt=dt) == Status.OK

    np.testing.assert_allclose(np.asarray(sb.v), np.asarray(bi.v), rtol=0, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(sb.u_e), np.asarray(bi.u_e), rtol=0, atol=5e-5
    )
