"""Ionic model tests: published resting/AP characteristics for TP06,
ToR-ORd dynCl and ToR-ORd dynCl + Land (reference models come from
``odes/`` via gotranx, e.g. ``demos/biv_endocardial.py:134-174``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fenicsx_beat_tpu.models import (
    tentusscher_panfilov_2006 as tp06,
    torord_dyncl,
    torord_dyncl_land,
)

ALL_MODELS = [tp06, torord_dyncl, torord_dyncl_land]


def _pace(model, T_ms, dt, **param_overrides):
    y0 = jnp.asarray(model.init_state_values()[:, None])
    p = jnp.asarray(model.init_parameter_values(**param_overrides))
    v_idx = model.state_index("V" if "V" in model._STATE_NAMES else "v")

    @jax.jit
    def run(y):
        def step(carry, _):
            y, t = carry
            y = model.generalized_rush_larsen(y, t, p, dt)
            return (y, t + dt), y[v_idx, 0]

        (y, _), vtr = jax.lax.scan(step, (y, 0.0), None, length=int(T_ms / dt))
        return y, vtr

    y, vtr = run(y0)
    return np.asarray(y), np.asarray(vtr)


@pytest.mark.parametrize("model", ALL_MODELS, ids=lambda m: m.__name__.split(".")[-1])
def test_model_contract(model):
    y = model.init_state_values()
    p = model.init_parameter_values()
    assert y.ndim == 1 and p.ndim == 1
    v_name = "V" if "V" in model._STATE_NAMES else "v"
    assert model.state_index(v_name) >= 0
    y2 = np.asarray(model.generalized_rush_larsen(y[:, None], 0.0, p, 0.01))
    assert y2.shape == (y.size, 1)
    assert np.isfinite(y2).all()
    y3 = np.asarray(model.forward_euler(y[:, None], 0.0, p, 0.001))
    assert np.isfinite(y3).all()


@pytest.mark.parametrize(
    "model,stim",
    [
        (tp06, dict(stim_start=10.0)),
        (torord_dyncl, dict(i_Stim_Start=10.0)),
        (torord_dyncl_land, dict(i_Stim_Start=10.0)),
    ],
    ids=["tp06", "torord", "torord_land"],
)
def test_action_potential_morphology(model, stim):
    y, vtr = _pace(model, T_ms=450.0, dt=0.02, **stim)
    rest = vtr[int(9.0 / 0.02)]
    peak = vtr.max()
    assert np.isfinite(y).all()
    assert -92.0 < rest < -80.0
    assert 20.0 < peak < 60.0
    # APD90 in the physiological range
    v90 = peak - 0.9 * (peak - rest)
    above = np.where(vtr > v90)[0]
    apd90 = (above[-1] - above[0]) * 0.02
    assert 150.0 < apd90 < 400.0


def test_torord_celltype_switch():
    """Epi/mid scalings change the AP (published transmural differences)."""
    _, v_endo = _pace(torord_dyncl, T_ms=400.0, dt=0.02, i_Stim_Start=5.0, celltype=0.0)
    _, v_epi = _pace(torord_dyncl, T_ms=400.0, dt=0.02, i_Stim_Start=5.0, celltype=1.0)
    _, v_mid = _pace(torord_dyncl, T_ms=400.0, dt=0.02, i_Stim_Start=5.0, celltype=2.0)

    def apd90(vtr):
        rest, peak = vtr[200], vtr.max()
        v90 = peak - 0.9 * (peak - rest)
        above = np.where(vtr > v90)[0]
        return (above[-1] - above[0]) * 0.02

    a_endo, a_epi, a_mid = apd90(v_endo), apd90(v_epi), apd90(v_mid)
    # mid-myocardial cells have the longest APD; epi shorter than endo
    assert a_mid > a_endo > a_epi


def test_land_tension_develops():
    model = torord_dyncl_land
    y0 = jnp.asarray(model.init_state_values()[:, None])
    p = jnp.asarray(model.init_parameter_values(i_Stim_Start=5.0))
    dt = 0.02

    @jax.jit
    def run(y):
        def step(carry, _):
            y, t = carry
            y = model.generalized_rush_larsen(y, t, p, dt)
            ta, _, _ = model.active_tension(y, p)
            return (y, t + dt), ta[0]

        (y, _), ta_tr = jax.lax.scan(step, (y, 0.0), None, length=int(300 / dt))
        return y, ta_tr

    _, ta = run(y0)
    ta = np.asarray(ta)
    # twitch: near-zero baseline, development to >5 kPa, partial relaxation
    assert ta[10] < 1.0
    assert ta.max() > 5.0
    assert ta[-1] < 0.8 * ta.max()


def test_torord_resting_stability():
    """Without stimulus the state drifts only slowly from the published IC."""
    y, vtr = _pace(torord_dyncl, T_ms=200.0, dt=0.02, i_Stim_Start=1e18)
    assert abs(vtr[-1] - (-89.74808)) < 1.0


def test_f32_f64_consistency():
    """One GRL step in f32 stays within mixed-precision tolerance of f64
    (the GPU production path runs f32; reference runs PETSc f64)."""
    import jax

    for model in ALL_MODELS:
        y64 = jnp.asarray(model.init_state_values()[:, None], dtype=jnp.float64)
        p64 = jnp.asarray(model.init_parameter_values(), dtype=jnp.float64)
        y = y64
        for k in range(20):
            y = model.generalized_rush_larsen(y, 0.05 * k, p64, 0.05)
        y32 = jnp.asarray(y64, dtype=jnp.float32)
        p32 = jnp.asarray(p64, dtype=jnp.float32)
        z = y32
        for k in range(20):
            z = model.generalized_rush_larsen(z, jnp.float32(0.05 * k), p32, jnp.float32(0.05))
        v_idx = model.state_index("V" if "V" in model._STATE_NAMES else "v")
        dv = abs(float(y[v_idx, 0]) - float(z[v_idx, 0]))
        assert np.isfinite(np.asarray(z)).all(), model.__name__
        assert dv < 0.05, f"{model.__name__}: f32 voltage drift {dv} mV after 20 steps"


# ---------------------------------------------------------------------------
# Tabulated TP06 (V-only transcendentals replaced by table interpolation;
# reference computes every rate exactly each step via gotranx codegen —
# tables are a throughput optimization off the main path and must stay
# faithful)


def test_tabulated_build_audit():
    fun = tp06.tabulated_rush_larsen(0.05)
    assert fun.fixed_dt == 0.05
    # build-time interpolation audit: every table within 1e-3 of exact
    worst = max(fun.table_error.values())
    assert worst < 1e-3, fun.table_error
    # finer tables shrink the error quadratically (linear interp)
    fine = tp06.tabulated_rush_larsen(0.05, n_entries=512)
    assert max(fine.table_error.values()) < 0.3 * worst


def test_tabulated_matches_exact_single_step():
    p = tp06.init_parameter_values(stim_amplitude=0.0)
    fun = tp06.tabulated_rush_larsen(0.05, p)
    rng = np.random.default_rng(0)
    y = tp06.init_state_values()[:, None] * np.ones((1, 64))
    # scatter V across the table range; perturb the rest multiplicatively
    y[0] = np.linspace(-95.0, 45.0, 64)
    y[1:] *= rng.uniform(0.9, 1.1, size=y[1:].shape)
    y = y.astype(np.float32)
    exact = np.asarray(tp06.generalized_rush_larsen(y, 0.0, p, 0.05))
    tab = np.asarray(fun(y, 0.0))
    rel = np.abs(tab - exact) / (1.0 + np.abs(exact))
    assert rel.max() < 5e-3, rel.max(axis=1)


def test_tabulated_full_action_potential():
    """Paced AP: morphology and upstroke timing match the exact model."""
    p = tp06.init_parameter_values(stim_start=10.0)
    fun = tp06.tabulated_rush_larsen(0.05, p)

    def pace(step):
        y0 = jnp.asarray(tp06.init_state_values()[:, None], dtype=jnp.float32)

        @jax.jit
        def run(y):
            def body(carry, _):
                y, t = carry
                # pin f32: the exact model promotes under the suite's x64
                # config, the tabulated one (f32 tables, production dtype)
                # does not — compare both at the f32 production precision
                y = step(y, t).astype(jnp.float32)
                return (y, t + 0.05), y[0, 0]

            (_, _), vtr = jax.lax.scan(body, (y, jnp.float32(0.0)), None, length=8000)
            return vtr

        return np.asarray(run(y0))

    v_ex = pace(lambda y, t: tp06.generalized_rush_larsen(y, t, p, 0.05))
    v_tab = pace(lambda y, t: fun(y, t))

    # upstroke time (first crossing of -20 mV) within 0.1 ms
    t_ex = np.argmax(v_ex > -20.0) * 0.05
    t_tab = np.argmax(v_tab > -20.0) * 0.05
    assert abs(t_ex - t_tab) < 0.1, (t_ex, t_tab)
    # peak and resting V
    assert abs(v_ex.max() - v_tab.max()) < 0.5
    assert abs(v_ex[-1] - v_tab[-1]) < 0.5
    # APD90 within 2.5%
    def apd90(v):
        peak, rest = v.max(), v[int(9.0 / 0.05)]
        v90 = peak - 0.9 * (peak - rest)
        above = np.where(v > v90)[0]
        return (above[-1] - above[0]) * 0.05

    a_ex, a_tab = apd90(v_ex), apd90(v_tab)
    assert abs(a_ex - a_tab) / a_ex < 0.025, (a_ex, a_tab)


def test_tabulated_step_matches_exact_numpy_step():
    """One table-driven TP06 step stays within its audited interpolation
    error of the exact step evaluated in float64 NumPy, across the whole
    voltage range of the tables."""
    p = tp06.init_parameter_values(stim_amplitude=0.0)
    fun = tp06.tabulated_rush_larsen(0.05, p, dtype=np.float64)
    rng = np.random.default_rng(1)
    n = 512
    y = tp06.init_state_values()[:, None] * np.ones((1, n))
    y[0] = np.linspace(-100.0, 50.0, n)
    y[1:] *= rng.uniform(0.95, 1.05, size=y[1:].shape)
    tab = np.asarray(fun(y, 0.0))
    exact = tp06.generalized_rush_larsen(y, 0.0, p, 0.05, xp=np)
    scale = np.abs(exact).max(axis=1)
    assert (np.abs(tab - exact).max(axis=1) / scale).max() < 1e-2
