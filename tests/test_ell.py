"""ELL + COO-tail SpMV (the unstructured-mesh operator format) against
SciPy float64: random patterns, rectangular transfers, the LV apex tail,
value-level combination, duplicate summing and the pytree contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu.ops.sparse import ELLMatrix, coo_to_ell


def _random_coo(n_rows, n_cols, nnz_per_row, band=None, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    if band is None:
        cols = rng.integers(0, n_cols, size=rows.size)
    else:
        cols = np.clip(rows + rng.integers(-band, band, size=rows.size), 0, n_cols - 1)
    vals = rng.standard_normal(rows.size)
    return rows, cols, vals


def _ell_and_csr(rows, cols, vals, shape):
    A = coo_to_ell(rows, cols, vals, shape, dtype=np.float64)
    return A, sp.csr_matrix((vals, (rows, cols)), shape=shape)


@pytest.mark.parametrize("band", [None, 150])
def test_spmv_matches_scipy(band):
    A, ref = _ell_and_csr(*_random_coo(2000, 2000, 7, band=band), (2000, 2000))
    A = A.to_device()
    x = np.random.default_rng(1).standard_normal(2000)
    np.testing.assert_allclose(np.asarray(A @ jnp.asarray(x)), ref @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.asarray(A.diagonal()), ref.diagonal(), atol=1e-15)


def test_rectangular_operator():
    """AMG transfer matrices are rectangular."""
    coo = sp.random(900, 2100, density=0.003, random_state=3, format="coo")
    A, ref = _ell_and_csr(coo.row, coo.col, coo.data, coo.shape)
    A = A.to_device()
    x = np.random.default_rng(2).standard_normal(2100)
    np.testing.assert_allclose(np.asarray(A @ jnp.asarray(x)), ref @ x, rtol=1e-12, atol=1e-13)


def test_lv_operator_with_apex_tail():
    """The production shape: LV stiffness whose welded-apex rows spill
    beyond the capped width into the COO tail."""
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry

    geo = get_lv_ellipsoid_geometry(psize_ref=0.55)
    V = fem.functionspace(geo.mesh, ("P", 1))
    rows, cols, _, kvals, shape = fem.assemble_mass_stiffness_coo(V, 1.0)
    ref = sp.csr_matrix((kvals, (rows, cols)), shape=shape)
    _, K = fem.assemble_mass_stiffness(V, 1.0)
    assert isinstance(K, ELLMatrix) and K.has_tail  # the apex overflows the width cap
    x = np.random.default_rng(0).standard_normal(V.ndofs)
    np.testing.assert_allclose(
        np.asarray(K.to_device() @ jnp.asarray(x)), ref @ x, rtol=1e-12, atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(K.diagonal()), ref.diagonal(), rtol=1e-12, atol=1e-15)


def test_combine_value_level():
    """Operators assembled from one (rows, cols) pattern combine value-wise
    — the dt-traced theta-system combination every solver relies on —
    including exact zeros that only one of them carries."""
    rng = np.random.default_rng(4)
    n = 1500
    rows, cols, da = _random_coo(n, n, 6, band=100, seed=5)
    db = rng.standard_normal(da.size)
    da[::7] = 0.0
    db[3::7] = 0.0
    A, refA = _ell_and_csr(rows, cols, da, (n, n))
    B, refB = _ell_and_csr(rows, cols, db, (n, n))
    C = A.to_device().combine(2.0, B.to_device(), -0.3)
    refC = 2.0 * refA - 0.3 * refB
    x = rng.standard_normal(n)
    np.testing.assert_allclose(np.asarray(C @ jnp.asarray(x)), refC @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(C.diagonal()), refC.diagonal(), atol=1e-13)


def test_coo_to_ell_sums_duplicates():
    rows = np.array([0, 0, 0, 1])
    cols = np.array([1, 1, 2, 0])
    vals = np.array([2.0, 3.0, 1.0, 4.0])
    A, ref = _ell_and_csr(rows, cols, vals, (2, 3))
    x = np.array([1.0, 10.0, 100.0])
    np.testing.assert_allclose(np.asarray(A.to_device() @ jnp.asarray(x)), [150.0, 4.0])
    np.testing.assert_allclose(ref @ x, [150.0, 4.0])


def test_pytree_roundtrip():
    A, ref = _ell_and_csr(*_random_coo(600, 600, 5, band=60), (600, 600))
    A = A.to_device()
    leaves, treedef = jax.tree_util.tree_flatten(A)
    A2 = jax.tree_util.tree_unflatten(treedef, leaves)
    x = np.random.default_rng(7).standard_normal(600)
    y = jax.jit(lambda M, v: M @ v)(A2, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), ref @ x, rtol=1e-13, atol=1e-13)
