"""Checkpoint / VTU writer tests (reference does IO through external
ADIOS2/io4dolfinx, ``demos/pace_train.py:179-189,222-249`` — here in-repo)."""

import numpy as np
import pytest

from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu.io import CheckpointWriter, VTUWriter, load_checkpoint


def test_checkpoint_roundtrip(tmp_path):
    mesh = meshmod.create_unit_square(None, 4, 4)
    path = tmp_path / "run"
    with CheckpointWriter(path, mesh) as w:
        for k in range(3):
            w.write(0.5 * k, np.full(mesh.num_vertices, float(k)))

    data = load_checkpoint(path)
    assert data.times.tolist() == [0.0, 0.5, 1.0]
    assert data.values.shape == (3, mesh.num_vertices)
    np.testing.assert_allclose(data.values[2], 2.0)
    np.testing.assert_allclose(data.coords, mesh.coords)
    np.testing.assert_array_equal(data.cells, mesh.cells)
    assert data.cell_type == "triangle"


def test_vtu_writer_produces_readable_xml(tmp_path):
    mesh = meshmod.create_unit_square(None, 3, 3)
    w = VTUWriter(tmp_path / "viz", mesh)
    v = np.linspace(-85.0, 40.0, mesh.num_vertices)
    w.write(0.0, {"v": v})
    w.write(1.0, {"v": v + 1})
    pvd = w.close()

    assert pvd.is_file()
    text = pvd.read_text()
    assert "VTKFile" in text
    vtus = sorted(pvd.parent.glob("*.vtu"))
    assert len(vtus) == 2
    import xml.etree.ElementTree as ET

    root = ET.parse(vtus[0]).getroot()
    assert root.tag == "VTKFile"


def test_checkpoint_portable_across_padding(tmp_path):
    """Checkpoints hold exactly the mesh's nodes, so a padded solver (the
    sharded solver pads the node axis to a device multiple) and the
    unpadded fused solver exchange them both ways."""
    import numpy as np
    import jax

    from fenicsx_beat_tpu.benchmarks.niederer import _build_solver, niederer_problem
    from fenicsx_beat_tpu.parallel import ShardedMonodomainSolver
    from jax.sharding import Mesh

    plain = _build_solver(dx=0.5)
    padded = ShardedMonodomainSolver(
        device_mesh=Mesh(np.array(jax.devices()[:8]), ("x",)),
        **niederer_problem(dx=0.5),
    )
    assert padded.part.n_pad > padded.part.n_global == plain._n
    assert plain.states.shape[1] == plain._n

    padded.solve((0.0, 0.5), dt=0.05)
    path = padded.save_state(tmp_path / "ckpt-pad-roundtrip", t=0.5)
    assert plain.load_state(path) == 0.5
    np.testing.assert_allclose(
        np.asarray(plain.v), np.asarray(padded.v), rtol=1e-6, atol=1e-7
    )
    # and back: unpadded checkpoint into the padded solver
    plain.solve((0.5, 1.0), dt=0.05)
    path2 = plain.save_state(tmp_path / "ckpt-plain-roundtrip", t=1.0)
    assert padded.load_state(path2) == 1.0
    np.testing.assert_allclose(
        np.asarray(padded.v), np.asarray(plain.v), rtol=1e-6, atol=1e-7
    )


MSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 2 2 7 1 1 2 3
2 2 2 8 1 1 3 4
3 1 2 5 1 1 2
4 1 2 6 1 3 4
$EndElements
"""

MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 2 1 0
10 0 0 0 1 0 0 1 5 2 0 0
11 0 1 0 1 1 1 1 6 2 0 0
1 0 0 0 1 1 0 1 7 2 10 -11
$EndEntities
$Nodes
1 4 1 4
2 1 0 4
1
2
3
4
0 0 0
1 0 0
1 1 0
0 1 0
$EndNodes
$Elements
3 4 1 4
2 1 2 2
1 1 2 3
2 1 3 4
1 10 1 1
3 1 2
1 11 1 1
4 3 4
$EndElements
"""


def test_read_msh_v22(tmp_path):
    from fenicsx_beat_tpu.io import read_msh

    p = tmp_path / "sq.msh"
    p.write_text(MSH22)
    mesh, ct, ft = read_msh(p)
    assert mesh.num_cells == 2 and mesh.num_vertices == 4 and mesh.tdim == 2
    assert ct is not None and set(ct.values) == {7, 8}
    assert ft is not None and set(ft.values) == {5, 6}
    # tagged facets resolve to real facets of the mesh with the right verts
    facets = mesh.entities(1)
    for fid, val in zip(ft.indices, ft.values):
        verts = set(int(v) for v in facets[fid])
        assert verts == ({0, 1} if val == 5 else {2, 3})
    # a solve runs on the imported mesh
    from fenicsx_beat_tpu import fem

    V = fem.functionspace(mesh, ("P", 1))
    mass, stiff = fem.assemble_mass_stiffness(V, 1.0)
    assert float(np.asarray(mass.diagonal()).sum()) > 0


def test_read_msh_v41_physical_via_entities(tmp_path):
    from fenicsx_beat_tpu.io import read_msh

    p = tmp_path / "sq41.msh"
    p.write_text(MSH41)
    mesh, ct, ft = read_msh(p)
    assert mesh.num_cells == 2 and mesh.num_vertices == 4
    assert ct is not None and set(ct.values) == {7}  # surface physical tag
    assert ft is not None and sorted(ft.values) == [5, 6]  # from $Entities


def test_mesh_npz_roundtrip(tmp_path):
    from fenicsx_beat_tpu import mesh as meshmod
    from fenicsx_beat_tpu.io import read_mesh, write_mesh

    m = meshmod.create_unit_square(None, 3, 2)
    path = write_mesh(tmp_path / "m.npz", m)
    m2 = read_mesh(path)
    np.testing.assert_array_equal(m2.coords, m.coords)
    np.testing.assert_array_equal(m2.cells, m.cells)
    assert m2.cell_type == m.cell_type


MSH22_NAMED = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
3
1 5 "ENDO_LV"
1 6 "EPI"
2 7 "MYOCARDIUM"
$EndPhysicalNames
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 2 2 7 1 1 2 3
2 2 2 7 1 1 3 4
3 1 2 5 1 1 2
4 1 2 6 1 3 4
$EndElements
"""


def test_read_msh_physical_names(tmp_path):
    from fenicsx_beat_tpu.io import read_msh, read_msh_physical_names

    p = tmp_path / "named.msh"
    p.write_text(MSH22_NAMED)
    names = read_msh_physical_names(p)
    assert names == {"ENDO_LV": (1, 5), "EPI": (1, 6), "MYOCARDIUM": (2, 7)}
    mesh, ct, ft = read_msh(p)
    # names resolve to the tag values the MeshTags carry
    assert 5 in ft.values and 6 in ft.values
    assert set(ct.values) == {7}


def test_read_msh_rejects_embedded_surface(tmp_path):
    from fenicsx_beat_tpu.io import read_msh

    curved = MSH22_NAMED.replace("3 1 1 0", "3 1 1 0.3")  # node off-plane
    p = tmp_path / "curved.msh"
    p.write_text(curved)
    with pytest.raises(NotImplementedError):
        read_msh(p)


def _msh41_binary_bytes() -> bytes:
    """Binary twin of the MSH41 ASCII fixture, packed per the published
    MSH 4.1 binary spec (little-endian, size_t = 8)."""
    import struct

    sz = lambda *v: np.array(v, "<u8").tobytes()  # noqa: E731
    out = bytearray()
    out += b"$MeshFormat\n4.1 1 8\n"
    out += struct.pack("<i", 1)  # endianness probe
    out += b"\n$EndMeshFormat\n"

    def curve(tag, bbox, phys, bounds):
        b = struct.pack("<i", tag) + np.array(bbox, "<f8").tobytes()
        b += sz(len(phys)) + np.array(phys, "<i4").tobytes()
        b += sz(len(bounds)) + np.array(bounds, "<i4").tobytes()
        return b

    out += b"$Entities\n"
    out += sz(0, 2, 1, 0)
    out += curve(10, [0, 0, 0, 1, 0, 0], [5], [0, 0])
    out += curve(11, [0, 1, 0, 1, 1, 1], [6], [0, 0])
    out += curve(1, [0, 0, 0, 1, 1, 0], [7], [10, -11])
    out += b"\n$EndEntities\n"

    out += b"$Nodes\n" + sz(1, 4, 1, 4)
    out += struct.pack("<3i", 2, 1, 0) + sz(4)
    out += sz(1, 2, 3, 4)
    out += np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], "<f8").tobytes()
    out += b"\n$EndNodes\n"

    out += b"$Elements\n" + sz(3, 4, 1, 4)
    out += struct.pack("<3i", 2, 1, 2) + sz(2)  # surface block: 2 triangles
    out += sz(1, 1, 2, 3) + sz(2, 1, 3, 4)
    out += struct.pack("<3i", 1, 10, 1) + sz(1)  # curve 10: 1 line
    out += sz(3, 1, 2)
    out += struct.pack("<3i", 1, 11, 1) + sz(1)  # curve 11: 1 line
    out += sz(4, 3, 4)
    out += b"\n$EndElements\n"
    return bytes(out)


def test_read_msh_v41_binary_matches_ascii(tmp_path):
    """Round trip: the binary v4.1 file (Gmsh's default output mode)
    parses to the SAME mesh and tags as its ASCII twin."""
    from fenicsx_beat_tpu.io import read_msh

    pa = tmp_path / "sq41.msh"
    pa.write_text(MSH41)
    pb = tmp_path / "sq41_bin.msh"
    pb.write_bytes(_msh41_binary_bytes())

    ma, cta, fta = read_msh(pa)
    mb, ctb, ftb = read_msh(pb)
    np.testing.assert_array_equal(mb.coords, ma.coords)
    np.testing.assert_array_equal(mb.cells, ma.cells)
    np.testing.assert_array_equal(ctb.values, cta.values)
    np.testing.assert_array_equal(ftb.indices, fta.indices)
    np.testing.assert_array_equal(ftb.values, fta.values)


def test_read_msh_v22_binary_rejected(tmp_path):
    from fenicsx_beat_tpu.io import read_msh

    p = tmp_path / "old_bin.msh"
    p.write_bytes(b"$MeshFormat\n2.2 1 8\n" + b"\x01\x00\x00\x00" + b"\n$EndMeshFormat\n")
    import pytest

    with pytest.raises(ValueError, match="binary .msh v2.2"):
        read_msh(p)
