"""Stencil (fixed-offset) SpMV: equivalence with ELL and solver integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
from fenicsx_beat_tpu.ops.sparse import StencilMatrix, ell_to_stencil


@pytest.mark.parametrize(
    "make_mesh",
    [
        lambda: meshmod.create_interval(None, 40),
        lambda: meshmod.create_unit_square(None, 9, 5),
        lambda: get_3D_slab_geometry(None, dx=1.0, Lx=8.0, Ly=4.0, Lz=2.0).mesh,
    ],
    ids=["interval", "square", "slab3d"],
)
def test_stencil_matches_ell(make_mesh):
    mesh = make_mesh()
    V = fem.functionspace(mesh, ("P", 1))
    mass, stiff = fem.assemble_mass_stiffness(V, 1.0)
    for A in (mass, stiff):
        st = ell_to_stencil(A)
        assert st is not None
        x = jnp.asarray(np.random.default_rng(0).standard_normal(V.ndofs))
        np.testing.assert_allclose(np.asarray(A @ x), np.asarray(st @ x), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(A.diagonal()), np.asarray(st.diagonal()), atol=1e-12
        )
    # mass and stiffness share the offset set (combined value-wise on device)
    assert ell_to_stencil(mass).offsets == ell_to_stencil(stiff).offsets


def test_stencil_with_values_combination():
    mesh = meshmod.create_unit_square(None, 6, 6)
    V = fem.functionspace(mesh, ("P", 1))
    mass, stiff = fem.assemble_mass_stiffness(V, 1.0)
    m_st, k_st = ell_to_stencil(mass), ell_to_stencil(stiff)
    A_ell = mass.with_values(2.0 * mass.vals + 0.3 * stiff.vals)
    A_st = m_st.with_values(2.0 * m_st.vals + 0.3 * k_st.vals)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(V.ndofs))
    np.testing.assert_allclose(np.asarray(A_ell @ x), np.asarray(A_st @ x), atol=1e-12)


def test_fused_solver_uses_stencil():
    from fenicsx_beat_tpu.fused import FusedMonodomainSolver
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn

    mesh = meshmod.create_unit_square(None, 8, 8)
    solver = FusedMonodomainSolver(
        mesh=mesh,
        M=0.001,
        ode_fun=fhn.forward_euler_jax
        if hasattr(fhn, "forward_euler_jax")
        else fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
    )
    assert isinstance(solver._mass, StencilMatrix)
    solver.solve((0.0, 1.0), dt=0.05)
    assert np.isfinite(np.asarray(solver.v)).all()


def _stencil_csr(offsets, vals):
    """SciPy float64 reference of a stencil operator."""
    import scipy.sparse as sp

    n = vals.shape[0]
    rows = np.repeat(np.arange(n), len(offsets))
    cols = (np.arange(n)[:, None] + np.asarray(offsets)[None, :]).ravel()
    v = np.asarray(vals, dtype=np.float64).ravel()
    keep = (cols >= 0) & (cols < n)
    return sp.csr_matrix((v[keep], (rows[keep], cols[keep])), shape=(n, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stencil_spmv_random_offsets_vs_scipy(seed):
    """XLA StencilMatrix over random offset sets (arbitrary shifts, both
    signs, rows near both ends) against SciPy."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 3000))
    K = int(rng.integers(3, 12))
    offs = np.unique(np.concatenate([[0], rng.integers(-(n // 3), n // 3, K)]))
    vals = rng.standard_normal((n, offs.size))
    # zero out entries whose column would fall outside [0, n)
    cols = np.arange(n)[:, None] + offs[None, :]
    vals[(cols < 0) | (cols >= n)] = 0.0
    st = StencilMatrix(offsets=tuple(int(d) for d in offs), vals=jnp.asarray(vals), shape=(n, n))
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(st @ jnp.asarray(x)), _stencil_csr(st.offsets, vals) @ x,
        rtol=1e-12, atol=1e-12,
    )


def test_stencil_spmv_symmetric_fuzz():
    """Random symmetric stencils (lane-like, row-carry and slab-like offset
    sets): the XLA SpMV matches SciPy and the operator is symmetric."""
    rng = np.random.default_rng(7)
    for offsets, n in [
        ((-5, -1, 0, 1, 5), 900),
        ((-129, -128, -1, 0, 1, 128, 129), 2500),
        ((-300, -128, -70, 0, 70, 128, 300), 9000),
    ]:
        vals = np.zeros((n, len(offsets)))
        for k, d in enumerate(offsets):
            if d < 0:
                continue
            col = rng.standard_normal(n)
            if d > 0:
                col[n - d:] = 0.0
            vals[:, k] = col
            if d > 0:
                vals[d:, offsets.index(-d)] = col[: n - d]
        ref = _stencil_csr(offsets, vals)
        assert abs(ref - ref.T).max() == 0.0
        x = rng.standard_normal(n)
        st = StencilMatrix(offsets=offsets, vals=jnp.asarray(vals), shape=(n, n))
        y = np.asarray(st @ jnp.asarray(x))
        np.testing.assert_allclose(y, ref @ x, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(float(x @ y), float(x @ (ref @ x)), rtol=1e-10)


def test_stencil_spmv_slab_offsets_vs_scipy():
    """A 40k-row operator with slab-like offsets (the Niederer pattern at
    a small width), jitted, against SciPy."""
    rng = np.random.default_rng(11)
    n = 40_000
    offsets = (-130, -129, -128, -1, 0, 1, 128, 129, 130)
    vals = rng.normal(size=(n, len(offsets)))
    rows = np.arange(n)
    for k, d in enumerate(offsets):
        vals[(rows + d < 0) | (rows + d >= n), k] = 0.0
    x = rng.normal(size=n)
    st = StencilMatrix(offsets=offsets, vals=jnp.asarray(vals), shape=(n, n))
    y = jax.jit(lambda A, v: A @ v)(st, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), _stencil_csr(offsets, vals) @ x, rtol=1e-12, atol=1e-12)


def test_fused_solver_state_is_unpadded():
    """The fused solver keeps exactly one column per node: no alignment
    padding, so states, voltage and activation share the mesh's size."""
    from fenicsx_beat_tpu.fused import FusedMonodomainSolver
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn

    mesh = meshmod.create_unit_square(None, 9, 5)
    solver = FusedMonodomainSolver(
        mesh=mesh, M=0.001, ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
    )
    n = mesh.num_vertices
    assert solver.states.shape == (fhn.init_state_values().shape[0], n)
    assert solver.activation_time.shape == (n,) and solver.v.shape == (n,)
    assert solver._mass.shape == (n, n)


def test_stencil_diagonal_and_combine_vs_scipy():
    """Value-level combination and the diagonal of a mass/stiffness stencil
    pair against the same combination in SciPy."""
    mesh = meshmod.create_unit_square(None, 9, 5)
    V = fem.functionspace(mesh, ("P", 1))
    mass, stiff = fem.assemble_mass_stiffness(V, 1.0)
    m_st, k_st = ell_to_stencil(mass), ell_to_stencil(stiff)
    ref = 1.5 * _stencil_csr(m_st.offsets, np.asarray(m_st.vals)) - 0.2 * _stencil_csr(
        k_st.offsets, np.asarray(k_st.vals)
    )
    A = m_st.combine(1.5, k_st, -0.2)
    x = np.random.default_rng(5).standard_normal(V.ndofs)
    np.testing.assert_allclose(np.asarray(A @ jnp.asarray(x)), ref @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(A.diagonal()), ref.diagonal(), atol=1e-14)


def test_assemble_mass_stiffness_auto_prefers_stencil():
    from fenicsx_beat_tpu.ops.sparse import ELLMatrix

    # structured slab: direct stencil assembly
    mesh = get_3D_slab_geometry(None, dx=1.0, Lx=8.0, Ly=4.0, Lz=2.0).mesh
    V = fem.functionspace(mesh, ("P", 1))
    mass_a, stiff_a = fem.assemble_mass_stiffness_auto(V, 1.0)
    assert isinstance(mass_a, StencilMatrix) and isinstance(stiff_a, StencilMatrix)
    mass_e, stiff_e = fem.assemble_mass_stiffness(V, 1.0)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(V.ndofs))
    np.testing.assert_allclose(np.asarray(mass_a @ x), np.asarray(mass_e @ x), atol=1e-12)
    np.testing.assert_allclose(np.asarray(stiff_a @ x), np.asarray(stiff_e @ x), atol=1e-12)
    # P2 declines the direct-stencil path but still returns a working pair
    V2 = fem.functionspace(mesh, ("P", 2))
    m2, k2 = fem.assemble_mass_stiffness_auto(V2, 1.0)
    assert isinstance(m2, (StencilMatrix, ELLMatrix))
    x2 = jnp.asarray(np.random.default_rng(4).standard_normal(V2.ndofs))
    m2e, _ = fem.assemble_mass_stiffness(V2, 1.0)
    np.testing.assert_allclose(np.asarray(m2 @ x2), np.asarray(m2e @ x2), atol=1e-12)


def test_ionic_kernel_block_rule():
    """The ionic kernel takes power-of-two node blocks and models that
    follow the row-wise ``xp`` convention."""
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.ops.ionic_kernel import build_ionic_step, supports

    assert supports(tp06.generalized_rush_larsen)
    assert not supports(fhn.forward_euler)
    with pytest.raises(ValueError):
        build_ionic_step(tp06.generalized_rush_larsen, 19, None, 0, block=96)
    build_ionic_step(tp06.generalized_rush_larsen, 19, None, 0, block=128)
