"""Multi-device sharding tests (8 virtual CPU devices via conftest).

Counterpart of the reference's ``mpirun -n 2`` CI job
(``.github/workflows/main-mpi.yml``): the sharded solver must reproduce the
single-device fused solver bit-for-bit-close on the same problem, and the
partitioned halo SpMV must agree with the global ELL SpMV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as DeviceMesh

from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu.conductivities import (
    default_conductivities,
    define_conductivity_tensor,
)
from fenicsx_beat_tpu.fused import FusedMonodomainSolver
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
from fenicsx_beat_tpu.mesh import locate_entities, meshtags
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
from fenicsx_beat_tpu.parallel.partition import partition_ell
from fenicsx_beat_tpu.parallel.solver import ShardedMonodomainSolver
from fenicsx_beat_tpu.stimulation import define_stimulus
from fenicsx_beat_tpu.units import ureg


def _device_mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices, have {len(devs)}")
    return DeviceMesh(np.array(devs[:n]), ("x",))


def _niederer_setup(dx=1.0):
    geo = get_3D_slab_geometry(None, dx=dx, Lx=20.0, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    conductivities = default_conductivities("Niederer")
    chi = conductivities["chi"]
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude
    tol = 1e-10
    cells = locate_entities(
        mesh,
        mesh.tdim,
        lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol),
    )
    tags = meshtags(mesh, mesh.tdim, cells, 1)
    I_s = define_stimulus(
        mesh=mesh,
        chi=chi,
        time=fem.Constant(0.0),
        subdomain_data=tags,
        marker=1,
        mesh_unit="mm",
        amplitude=50_000.0,
        duration=2.0,
    )
    M = define_conductivity_tensor(f0=geo.f0, **conductivities)
    common = dict(
        mesh=mesh,
        M=M,
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=1.0,
        C_m=C_m,
    )
    return common


@pytest.mark.parametrize("n_devices", [2, 8])
def test_partitioned_spmv_matches_global(n_devices):
    _device_mesh(n_devices)  # skip guard
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=10.0, Ly=5.0, Lz=3.0)
    V = fem.functionspace(geo.mesh, ("P", 1))
    mass, stiff = fem.assemble_mass_stiffness(V, 1.0)
    part, cols, vals, tail = partition_ell(stiff, n_devices)
    assert tail is None  # slab operators have no spilled high-degree rows
    rng = np.random.default_rng(0)
    x = rng.standard_normal(V.ndofs)
    y_ref = np.asarray(stiff @ jnp.asarray(x))

    xp = np.zeros(part.n_pad)
    xp[: V.ndofs] = x
    xl = xp.reshape(n_devices, part.n_local)
    H = part.halo
    y = np.zeros_like(xp)
    for d in range(n_devices):
        left = xl[d - 1][-H:] if (d > 0 and H) else np.zeros(H)
        right = xl[d + 1][:H] if (d < n_devices - 1 and H) else np.zeros(H)
        x_ext = np.concatenate([left, xl[d], right])
        y[d * part.n_local : (d + 1) * part.n_local] = np.sum(
            np.asarray(vals[d]) * x_ext[np.asarray(cols[d])], axis=1
        )
    np.testing.assert_allclose(y[: V.ndofs], y_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_solver_matches_fused(n_devices):
    dmesh = _device_mesh(n_devices)
    common = _niederer_setup(dx=1.0)
    T, dt = 2.0, 0.05

    fused = FusedMonodomainSolver(**common)
    fused.solve((0.0, T), dt=dt)
    v_fused = np.asarray(fused.v)

    sharded = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    sharded.solve((0.0, T), dt=dt)
    v_sharded = np.asarray(sharded.v)

    # same algorithm, same dtype; differences only from CG reduction order
    np.testing.assert_allclose(v_sharded, v_fused, rtol=1e-8, atol=1e-7)

    a_f = fused.activation_times()
    a_s = sharded.activation_times()
    np.testing.assert_allclose(a_s, a_f, rtol=1e-8, atol=1e-8)


def test_sharded_ionic_kernel_interpret_matches_xla():
    """Inside shard_map the ionic step through the Pallas kernel
    (interpreter on the CPU) reproduces the jnp model through XLA, for
    both Strang half-steps."""
    dmesh = _device_mesh(4)
    common = dict(_niederer_setup(dx=1.0), theta=0.5)
    v = {}
    for route in ("xla", "interpret"):
        sharded = ShardedMonodomainSolver(device_mesh=dmesh, ionic_kernel=route, **common)
        assert sharded.ionic_route == route
        sharded.solve((0.0, 1.0), dt=0.05)
        v[route] = np.asarray(sharded.v)
    np.testing.assert_allclose(v["interpret"], v["xla"], rtol=1e-10, atol=1e-10)
    assert ShardedMonodomainSolver(device_mesh=dmesh, **common).ionic_route == "xla"


def test_sharded_solve_compiles_one_chunk_program():
    """Chunks after the first reuse its compiled program: the time the
    chunk returns is replicated over the mesh, like the scalars the first
    chunk received."""
    sharded = ShardedMonodomainSolver(device_mesh=_device_mesh(4), **_niederer_setup(dx=1.0))
    sharded.solve((0.0, 0.5), dt=0.05, save_freq=5)
    sharded.solve((0.5, 1.0), dt=0.05, save_freq=5)
    assert sharded._run_chunk_ops._cache_size() == 1


def test_sharded_solver_activation_progresses():
    dmesh = _device_mesh(8)
    common = _niederer_setup(dx=1.0)
    solver = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    solver.solve((0.0, 5.0), dt=0.05)
    act = solver.activation_times()
    # stimulus region must have activated, far corner must not
    assert (act >= 0).any()
    assert (act < 0).any()
    v = np.asarray(solver.v)
    assert v.max() > 0.0  # depolarized somewhere
    assert v.min() < -80.0  # resting elsewhere


def test_sharded_solver_with_padding():
    """Node count NOT divisible by the device count: padded dofs must stay
    inert (no NaNs from zero-filled ionic states, no tolerance inflation) —
    regression for the zero-fill pad bug."""
    dmesh = _device_mesh(8)
    common = _niederer_setup(dx=1.0)
    # shrink to a mesh whose node count is not a multiple of 8
    from fenicsx_beat_tpu.geometry import get_3D_slab_geometry

    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=6.0, Lz=3.0)
    common = dict(common, mesh=geo.mesh)
    # rebuild stimulus/conductivity for this mesh
    conds = default_conductivities("Niederer")
    tol = 1e-10
    cells = locate_entities(
        geo.mesh,
        3,
        lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol),
    )
    tags = meshtags(geo.mesh, 3, cells, 1)
    common["I_s"] = define_stimulus(
        mesh=geo.mesh,
        chi=conds["chi"],
        time=fem.Constant(0.0),
        subdomain_data=tags,
        marker=1,
        mesh_unit="mm",
        amplitude=50_000.0,
        duration=2.0,
    )
    common["M"] = define_conductivity_tensor(f0=geo.f0, **conds)

    n = fem.functionspace(geo.mesh, ("P", 1)).ndofs
    assert n % 8 != 0, "test requires a padded partition"

    fused = FusedMonodomainSolver(**common)
    fused.solve((0.0, 2.0), dt=0.05)
    sharded = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    sharded.solve((0.0, 2.0), dt=0.05)
    v_f, v_s = np.asarray(fused.v), np.asarray(sharded.v)
    assert np.isfinite(v_s).all()
    assert v_s.max() > 0.0  # the stimulus depolarized (CG actually ran)
    np.testing.assert_allclose(v_s, v_f, rtol=1e-7, atol=1e-6)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_unstructured_lv_matches_fused(n_devices):
    """LV ellipsoid (unstructured: hybrid ELL+tail operator from the welded
    apex) sharded over the device mesh must match the fused solver — the
    reference partitions arbitrary meshes via DOLFINx (geometry.py:112-139
    there); here RCM renumbering + tail-aware partitioning plays that role."""
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.stimulation import TimeWindow, dx as dx_measure
    from fenicsx_beat_tpu import Stimulus

    dmesh = _device_mesh(n_devices)
    geo = get_lv_ellipsoid_geometry(None, psize_ref=0.6)
    mesh = geo.mesh

    # apex-region stimulus (cells below the 20th percentile of x)
    coords = mesh.coords
    x_cut = np.percentile(coords[:, 0], 20.0)
    cells = locate_entities(mesh, mesh.tdim, lambda x: x[0] <= x_cut)
    tags = meshtags(mesh, mesh.tdim, cells, 1)
    dx = dx_measure(mesh, subdomain_data=tags)
    I_s = Stimulus(expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0), dZ=dx, marker=1)

    common = dict(
        mesh=mesh,
        M=define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")),
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=1.0,
    )

    fused = FusedMonodomainSolver(**common)
    assert fused._mass.has_tail or not hasattr(fused._mass, "has_tail")
    fused.solve((0.0, 2.0), dt=0.05)
    v_fused = np.asarray(fused.v)

    sharded = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    assert sharded._perm is not None  # RCM renumbering engaged
    assert sharded._tail is not None  # apex rows spilled into the COO tail
    sharded.solve((0.0, 2.0), dt=0.05)
    v_sharded = np.asarray(sharded.v)

    assert np.isfinite(v_sharded).all()
    assert v_sharded.max() > 0.0  # stimulus depolarized the apex
    np.testing.assert_allclose(v_sharded, v_fused, rtol=1e-7, atol=1e-6)
    np.testing.assert_allclose(
        sharded.activation_times(), fused.activation_times(), rtol=1e-8, atol=1e-8
    )


def test_sharded_general_stimulus_matches_fused():
    """Non-separable stimulus (arbitrary space-time callable, not a
    TimeWindow): the sharded solver assembles it per device inside the
    step; must match the fused solver's global assembly."""
    import jax.numpy as jnp
    from fenicsx_beat_tpu import Stimulus
    from fenicsx_beat_tpu.stimulation import dx as dx_measure

    dmesh = _device_mesh(8)
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    tol = 1e-10
    cells = locate_entities(
        mesh, mesh.tdim,
        lambda x: (x[0] <= 3.0 + tol) & (x[1] <= 3.0 + tol) & (x[2] <= 3.0 + tol),
    )
    tags = meshtags(mesh, mesh.tdim, cells, 1)
    dx = dx_measure(mesh, subdomain_data=tags)

    def expr(x, t):  # traveling gaussian * ramp — not separable
        return 40.0 * jnp.exp(-((x[0] - 0.5 * t) ** 2)) * jnp.maximum(0.0, 1.0 - t / 4.0)

    I_s = Stimulus(expr=expr, dZ=dx, marker=1)
    common = dict(
        mesh=mesh,
        M=define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")),
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=1.0,
    )
    fused = FusedMonodomainSolver(**common)
    fused.solve((0.0, 2.0), dt=0.05)
    sharded = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    assert len(sharded._gen_tables) == 1  # general path engaged
    sharded.solve((0.0, 2.0), dt=0.05)
    np.testing.assert_allclose(
        np.asarray(sharded.v), np.asarray(fused.v), rtol=1e-7, atol=1e-6
    )


def test_sharded_two_marker_matches_fused():
    """Two-marker ionic models (DolfinMultiODESolver semantics) on the
    sharded path: per-node masks shard along the node axis and survive the
    RCM-free slab partition; must match the fused multi-marker solver."""
    dmesh = _device_mesh(8)
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    conds = default_conductivities("Niederer")
    tol = 1e-10
    cells = locate_entities(
        mesh, mesh.tdim,
        lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol),
    )
    tags = meshtags(mesh, mesh.tdim, cells, 1)
    I_s = define_stimulus(
        mesh=mesh,
        chi=conds["chi"],
        time=fem.Constant(0.0),
        subdomain_data=tags,
        marker=1,
        mesh_unit="mm",
        amplitude=50_000.0,
        duration=2.0,
    )
    V = fem.functionspace(mesh, ("P", 1))
    coords = V.tabulate_dof_coordinates()
    marker_arr = np.where(coords[:, 0] < 10.0, 1, 2)
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    common = dict(
        mesh=mesh,
        M=define_conductivity_tensor(f0=geo.f0, **conds),
        ode_fun={1: tp06.generalized_rush_larsen, 2: tp06.generalized_rush_larsen},
        init_states={
            1: tp06.init_state_values(),
            2: tp06.init_state_values(V=-60.0),
        },
        parameters={1: params, 2: params},
        v_index={1: tp06.state_index("V"), 2: tp06.state_index("V")},
        ode_markers=marker_arr,
        I_s=I_s,
        theta=1.0,
        C_m=(1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude,
    )
    fused = FusedMonodomainSolver(**common)
    fused.solve((0.0, 2.0), dt=0.05)
    sharded = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    assert sharded._params_sharded  # masks travel along the node axis
    sharded.solve((0.0, 2.0), dt=0.05)
    np.testing.assert_allclose(
        np.asarray(sharded.v), np.asarray(fused.v), rtol=1e-7, atol=1e-6
    )


def test_ecg_recovery_from_sharded_solution():
    """Postprocessing parity: ECG recovery over a sharded solve's voltage
    matches the fused solve's (the reference runs ECG under MPI;
    here recovery consumes the gathered, original-order voltage)."""
    from fenicsx_beat_tpu.ecg import ECGRecovery

    dmesh = _device_mesh(8)
    common = _niederer_setup(dx=1.0)
    T, dt = 5.0, 0.05

    fused = FusedMonodomainSolver(**common)
    fused.solve((0.0, T), dt=dt)
    sharded = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    sharded.solve((0.0, T), dt=dt)

    V = fem.functionspace(common["mesh"], ("P", 1))
    electrodes = [(25.0, 3.5, 1.5), (10.0, 20.0, 1.5)]
    phies = []
    for solver in (fused, sharded):
        v_fn = fem.Function(V)
        v_fn.x.array[:] = np.asarray(solver.v)
        rec = ECGRecovery(v=v_fn)
        rec.solve()
        phies.append([fem.assemble_scalar(rec.eval(p)) for p in electrodes])
    assert abs(phies[0][0]) > 0  # non-trivial signal
    np.testing.assert_allclose(phies[1], phies[0], rtol=1e-6, atol=1e-9)


def test_sharded_checkpoint_roundtrip_cross_solver():
    """Checkpoints are stored in original dof order: a sharded solver's
    state restores into a fused solver (and back) with exact resume."""
    dmesh = _device_mesh(8)
    common = _niederer_setup(dx=1.0)

    # reference: sharded run with the same two-segment chunking (resume
    # resets the CG warm start, so chunk boundaries must match for
    # exactness)
    ref = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    ref.solve((0.0, 2.0), dt=0.05)
    ref.solve((2.0, 4.0), dt=0.05)
    v_ref = np.asarray(ref.v)

    a = ShardedMonodomainSolver(device_mesh=dmesh, **common)
    a.solve((0.0, 2.0), dt=0.05)
    import tempfile, pathlib
    with tempfile.TemporaryDirectory() as d:
        ckpt = a.save_state(pathlib.Path(d) / "mid", t=2.0)

        # sharded -> sharded resume: exact
        b = ShardedMonodomainSolver(device_mesh=dmesh, **common)
        t0 = b.load_state(ckpt)
        assert t0 == 2.0
        b.solve((t0, 4.0), dt=0.05)
        np.testing.assert_allclose(np.asarray(b.v), v_ref, atol=1e-12)

        # sharded -> fused resume (original-order portability): within
        # cross-solver CG reduction-order tolerance
        c = FusedMonodomainSolver(**common)
        t0 = c.load_state(ckpt)
        c.solve((t0, 4.0), dt=0.05)
        np.testing.assert_allclose(np.asarray(c.v), v_ref, rtol=1e-6, atol=2e-5)


def test_make_device_mesh_and_coordinator():
    """Multi-host helpers: mesh over the virtual-CPU devices, coordinator
    gate (the reference's comm.rank==0), over-subscription error."""
    import pytest

    from fenicsx_beat_tpu.parallel import is_coordinator, make_device_mesh

    mesh = make_device_mesh(4)
    assert mesh.devices.shape == (4,) and mesh.axis_names == ("x",)
    full = make_device_mesh()
    assert full.devices.size >= 4
    assert is_coordinator() is True  # single-process test environment
    with pytest.raises(ValueError):
        make_device_mesh(10_000)


def test_initialize_distributed_single_process_graceful():
    """With no cluster environment, initialize_distributed must degrade to
    single-process (and stay idempotent) rather than raise — the same
    script runs serial and under a launcher, like the reference with and
    without mpirun."""
    from fenicsx_beat_tpu.parallel import initialize_distributed

    initialize_distributed()
    initialize_distributed()  # idempotent second call


def test_sharded_unstructured_matches_fused():
    """On the unstructured LV ellipsoid the sharded solver (RCM
    renumbering, per-device ELL blocks, COO apex tail, ppermute halos;
    4 devices) reproduces the single-device fused solver."""
    from fenicsx_beat_tpu.fused import FusedMonodomainSolver
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu.stimulation import TimeWindow, dx as dx_measure
    from fenicsx_beat_tpu import Stimulus

    dmesh = _device_mesh(4)
    geo = get_lv_ellipsoid_geometry(None, psize_ref=0.9)
    mesh = geo.mesh
    cells = locate_entities(mesh, 3, lambda x: x[0] <= np.percentile(mesh.coords[:, 0], 20))
    tags = meshtags(mesh, 3, cells, 1)
    I_s = Stimulus(
        expr=TimeWindow(amplitude=40.0, start=0.0, duration=1.0),
        dZ=dx_measure(mesh, subdomain_data=tags), marker=1,
    )
    common = dict(
        mesh=mesh, M=0.01,
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
        I_s=I_s, theta=1.0,
    )
    sharded = ShardedMonodomainSolver(
        device_mesh=dmesh, cg_rtol=1e-12, cg_atol=1e-14, **common
    )
    assert sharded._perm is not None and sharded._tail is not None
    sharded.solve((0.0, 0.5), dt=0.1)
    fused = FusedMonodomainSolver(params={"ksp_rtol": 1e-12, "ksp_atol": 1e-14}, **common)
    fused.solve((0.0, 0.5), dt=0.1)

    np.testing.assert_allclose(np.asarray(sharded.v), np.asarray(fused.v), rtol=0, atol=1e-9)
    np.testing.assert_allclose(sharded.activation_times(), fused.activation_times(), atol=1e-10)
