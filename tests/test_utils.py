"""Utils tests — mirror of reference ``tests/test_utils.py``:
expand_layer / expand_layer_biv marker placement probed at physical points."""

import numpy as np

import fenicsx_beat_tpu as beat
from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu import mesh as meshmod


def test_expand_layer_single():
    N = 50
    mesh = meshmod.create_unit_square(None, N, N)

    endo_marker, epi_marker = 1, 2
    tol = 1.0e-8
    fdim = mesh.tdim - 1

    facets_endo = meshmod.locate_entities_boundary(mesh, fdim, lambda x: x[0] <= tol)
    facets_epi = meshmod.locate_entities_boundary(mesh, fdim, lambda x: x[0] >= 1 - tol)
    marked_facets = np.hstack([facets_endo, facets_epi])
    marked_values = np.hstack(
        [np.full(len(facets_endo), endo_marker), np.full(len(facets_epi), epi_marker)]
    )
    ft = meshmod.meshtags(mesh, fdim, marked_facets, marked_values)

    V = fem.functionspace(mesh, ("P", 1))
    output_mid_marker, output_endo_marker, output_epi_marker = 4, 3, 1
    markers = beat.utils.expand_layer(
        V=V,
        ft=ft,
        endo_marker=endo_marker,
        epi_marker=epi_marker,
        endo_size=0.3,
        epi_size=0.3,
        output_mid_marker=output_mid_marker,
        output_endo_marker=output_endo_marker,
        output_epi_marker=output_epi_marker,
    )

    points = np.array([(x, y) for x in [0.0, 0.1, 0.2] for y in [0.0, 0.5, 1.0]])

    endo = beat.utils.evaluate_function(markers, points)
    assert np.allclose(endo, output_endo_marker)

    mid = beat.utils.evaluate_function(markers, points + np.array([0.4, 0.0]))
    assert np.allclose(mid, output_mid_marker)

    epi = beat.utils.evaluate_function(markers, points + np.array([0.8, 0.0]))
    assert np.allclose(epi, output_epi_marker)


def test_expand_layer_biv():
    N = 50
    mesh = meshmod.create_unit_square(None, N, N)

    endo_lv_marker, endo_rv_marker, epi_marker = 1, 2, 3
    tol = 1.0e-10
    fdim = mesh.tdim - 1

    facets_lv_endo = meshmod.locate_entities_boundary(
        mesh, fdim, lambda x: np.logical_and(x[1] <= tol, x[0] <= 0.5 + tol)
    )
    facets_rv_endo = meshmod.locate_entities_boundary(
        mesh, fdim, lambda x: np.logical_and(x[1] >= 1 - tol, x[0] <= 0.5 + tol)
    )
    facets_epi = meshmod.locate_entities_boundary(mesh, fdim, lambda x: x[0] >= 1 - tol)

    marked_facets = np.hstack([facets_lv_endo, facets_rv_endo, facets_epi])
    marked_values = np.hstack(
        [
            np.full(len(facets_lv_endo), endo_lv_marker),
            np.full(len(facets_rv_endo), endo_rv_marker),
            np.full(len(facets_epi), epi_marker),
        ]
    )
    ft = meshmod.meshtags(mesh, fdim, marked_facets, marked_values)

    V = fem.functionspace(mesh, ("P", 1))
    output_mid_marker, output_endo_marker, output_epi_marker = 4, 3, 1
    markers = beat.utils.expand_layer_biv(
        V=V,
        ft=ft,
        endo_lv_marker=endo_lv_marker,
        endo_rv_marker=endo_rv_marker,
        epi_marker=epi_marker,
        endo_size=0.3,
        epi_size=0.3,
        output_mid_marker=output_mid_marker,
        output_endo_marker=output_endo_marker,
        output_epi_marker=output_epi_marker,
    )

    endo_points = np.array([(0.0, 0.0), (0.0, 1.0), (0.2, 0.2), (0.2, 0.8)])
    mid_points = np.array(
        [(0.5 + i, 0.5 + j) for i in [-0.1, 0.0, 0.1] for j in [-0.1, 0.0, 0.1]] + [(0.0, 0.5)]
    )
    epi_points = np.array([(1.0, 0.0), (1.0, 1.0), (0.8, 0.2), (0.8, 0.8)])

    endo = beat.utils.evaluate_function(markers, endo_points)
    assert np.allclose(endo, output_endo_marker)

    mid = beat.utils.evaluate_function(markers, mid_points)
    assert np.allclose(mid, output_mid_marker)

    epi = beat.utils.evaluate_function(markers, epi_points)
    assert np.allclose(epi, output_epi_marker)


def test_space_from_string():
    mesh = meshmod.create_unit_square(None, 3, 3)
    for s, ndofs in [
        ("Lagrange_1", mesh.num_vertices),
        ("P_1", mesh.num_vertices),
        ("CG_1", mesh.num_vertices),
        ("DG_1", mesh.num_cells * 3),
    ]:
        V = beat.utils.space_from_string(s, mesh, dim=1)
        assert V.ndofs == ndofs

    import pytest

    with pytest.raises(ValueError, match="Unknown element family"):
        beat.utils.parse_element("Bogus_1", mesh, 1)


def test_local_project_same_space():
    mesh = meshmod.create_unit_square(None, 3, 3)
    V = fem.functionspace(mesh, ("P", 1))
    v = fem.Function(V)
    v.x.array[:] = 7.0
    u = beat.utils.local_project(v, V)
    assert np.allclose(u.x.array, 7.0)


def test_vector_space_blocked_layout_and_eval():
    """dim>1 spaces use the interleaved blocked layout (reference
    utils.py:87-112 builds these via basix blocked elements)."""
    mesh = meshmod.create_unit_square(None, 4, 4)
    V3 = beat.utils.space_from_string("P_1", mesh, dim=3)
    assert V3.block_size == 3
    assert V3.value_shape == (3,)
    assert V3.ndofs == 3 * mesh.num_vertices

    f = fem.Function(V3, name="f0")
    f.interpolate(lambda x: np.stack([np.ones_like(x[0]), x[0], x[1]]))
    comp = f.x.array.reshape(-1, 3)
    assert np.allclose(comp[:, 0], 1.0)
    assert np.allclose(comp[:, 1], V3.scalar_space.dof_coords[:, 0])

    # pointwise evaluation returns one value per component
    vals = f.eval(np.array([0.3, 0.45]))
    assert vals.shape == (3,)
    assert np.allclose(vals, [1.0, 0.3, 0.45], atol=1e-12)


def test_vector_function_local_project_and_io_roundtrip(tmp_path):
    """A fiber-like vector Function survives cross-space local_project and
    VTU/checkpoint output."""
    mesh = meshmod.create_unit_square(None, 3, 3)
    V3 = beat.utils.space_from_string("P_1", mesh, dim=3)
    f = fem.Function(V3, name="f0")
    f.interpolate(lambda x: np.stack([x[0], x[1], np.zeros_like(x[0])]))

    # cross-degree projection: P1 vector -> P2 vector, linear fields exact
    W3 = beat.utils.space_from_string("P_2", mesh, dim=3)
    g = beat.utils.local_project(f, W3)
    gc = g.x.array.reshape(-1, 3)
    assert np.allclose(gc[:, 0], W3.scalar_space.dof_coords[:, 0], atol=1e-12)
    assert np.allclose(gc[:, 1], W3.scalar_space.dof_coords[:, 1], atol=1e-12)

    # VTU: vector point data with NumberOfComponents=3
    from fenicsx_beat_tpu.io import CheckpointWriter, VTUWriter, load_checkpoint

    w = VTUWriter(tmp_path / "vtu", mesh, name="f0")
    w.write(0.0, f.x.array.reshape(-1, 3))
    w.close()
    frame = (tmp_path / "vtu" / "frame_000000.vtu").read_text()
    assert 'NumberOfComponents="3"' in frame

    # checkpoint round-trip of the flat blocked array
    cw = CheckpointWriter(tmp_path / "chk", mesh)
    cw.write(0.0, f.x.array)
    cw.save()
    data = load_checkpoint(tmp_path / "chk")
    back = fem.Function(V3)
    back.x.array[:] = data.values[0]
    assert np.allclose(back.x.array, f.x.array, atol=1e-6)


def test_vector_space_assembly_guard():
    import pytest

    mesh = meshmod.create_unit_square(None, 3, 3)
    V3 = fem.functionspace(mesh, ("P", 1, (3,)))
    with pytest.raises(NotImplementedError, match="blocked"):
        fem.assemble_mass_stiffness(V3, 1.0)


def test_laplace_solve_amg_matches_jacobi():
    """The SA-AMG path of laplace_solve (the in-repo BoomerAMG
    counterpart, reference ``utils.py:196-205``) reproduces the Jacobi
    path to solver tolerance and engages automatically above 5k dofs."""
    N = 80  # 6561 dofs: over the auto threshold
    mesh = meshmod.create_unit_square(None, N, N)
    fdim = mesh.tdim - 1
    tol = 1e-8
    f_lo = meshmod.locate_entities_boundary(mesh, fdim, lambda x: x[0] <= tol)
    f_hi = meshmod.locate_entities_boundary(mesh, fdim, lambda x: x[0] >= 1 - tol)
    V = fem.functionspace(mesh, ("P", 1))
    lo = fem.locate_dofs_topological(V, fdim, f_lo)
    hi = fem.locate_dofs_topological(V, fdim, f_hi)
    bcs = [fem.dirichletbc(0.0, lo, V), fem.dirichletbc(1.0, hi, V)]

    arr_amg = beat.utils.laplace_solve(V, bcs)  # auto -> AMG at this size
    arr_jac = beat.utils.laplace_solve(V, bcs, precond="jacobi")
    np.testing.assert_allclose(arr_amg, arr_jac, rtol=0, atol=1e-7)
    # the solution is the linear transmural coordinate
    np.testing.assert_allclose(arr_amg, mesh.coords[:, 0], rtol=0, atol=1e-6)

    import pytest

    with pytest.raises(ValueError, match="precond"):
        beat.utils.laplace_solve(V, bcs, precond="boomer")
