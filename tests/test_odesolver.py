"""ODE-layer tests — mirror of reference ``tests/test_odesolver.py``:
forward-Euler convergence, DolfinODESolver transfer state machine,
DolfinMultiODESolver marker partitioning."""

import numpy as np

from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu.odesolver import DolfinMultiODESolver, DolfinODESolver, ODESystemSolver


def simple_ode_forward_euler(states, t, dt, parameters):
    v, s = states
    a, b = parameters
    values = np.zeros_like(states)
    values[0] = v - a * s * dt
    values[1] = s + b * v * dt
    return values


def test_simple_ode_odesystemsolver():
    num_points = 1
    parameters = np.array([1, 1])
    t_bound = 1.0
    t0 = 0.0
    x = np.arange(0.1, t_bound + 0.1, 0.1)
    y = np.zeros((len(x), 2))
    sol = np.vstack((np.cos(x), np.sin(x))).T

    errors = []
    for dt in [0.1, 0.01, 0.001, 0.0001]:
        states = np.zeros((2, num_points))
        states.T[:] = [1, 0]
        ode = ODESystemSolver(
            fun=simple_ode_forward_euler,
            states=states,
            parameters=parameters,
        )
        j = 0
        t = 0.0
        for _ in range(int((t_bound - t0) / dt)):
            ode.step(t, dt)
            t += dt
            if np.isclose(t, x[j]):
                y[j, :] = ode.states[:, 0]
                j += 1
        errors.append(np.linalg.norm(sol - y))
    rates = [np.log(e1 / e2) / np.log(10) for e1, e2 in zip(errors[:-1], errors[1:])]
    assert np.allclose(rates, 1, atol=0.01)


def test_DolfinODESolver():
    N = 5
    mesh = meshmod.create_unit_square(None, N, N)

    V_pde = fem.functionspace(mesh, ("P", 1))
    v_pde = fem.Function(V_pde)
    V_ode = fem.functionspace(mesh, ("P", 1))
    v_ode = fem.Function(V_ode)

    N_ode = V_ode.ndofs

    v0, s0 = 1.0, 2.0
    init_states = np.array([v0, s0])
    parameters = np.array([1, 1])
    ode = DolfinODESolver(
        v_ode=v_ode,
        v_pde=v_pde,
        init_states=init_states,
        parameters=parameters,
        fun=simple_ode_forward_euler,
        num_states=2,
        v_index=0,
    )

    assert ode.full_values.shape == (2, N_ode)
    assert ode.values.shape == (2, N_ode)
    assert np.allclose(ode.values[0, :], v0)
    assert np.allclose(ode.values[1, :], s0)

    dt = 0.1
    ode.step(0.0, dt)
    assert np.allclose(ode.values[0, :], v0 - s0 * dt)
    assert np.allclose(ode.values[1, :], s0 + v0 * dt)
    # dolfin-style function not yet updated
    assert np.allclose(v_ode.x.array, 0.0)
    ode.to_dolfin()
    assert np.allclose(v_ode.x.array, v0 - s0 * dt)
    # PDE function untouched until the explicit transfer
    assert np.allclose(v_pde.x.array, 0.0)
    ode.ode_to_pde()
    assert np.allclose(v_pde.x.array, v0 - s0 * dt)
    v_pde.x.array[:] = 1.0
    ode.pde_to_ode()
    assert np.allclose(v_ode.x.array, 1.0)
    ode.from_dolfin()
    assert np.allclose(ode.values[0, :], 1.0)
    assert np.allclose(ode.values[1, :], s0 + v0 * dt)

    states = ode.states_to_dolfin()
    assert len(states) == 2
    assert np.allclose(states[0].x.array, 1.0)
    assert np.allclose(states[1].x.array, s0 + v0 * dt)


def test_DolfinODESolver_cross_space():
    """Transfer between different ODE (P2) and PDE (P1) spaces."""
    mesh = meshmod.create_unit_square(None, 4, 4)
    V_pde = fem.functionspace(mesh, ("P", 1))
    v_pde = fem.Function(V_pde)
    V_ode = fem.functionspace(mesh, ("P", 2))
    v_ode = fem.Function(V_ode)

    ode = DolfinODESolver(
        v_ode=v_ode,
        v_pde=v_pde,
        init_states=np.array([1.0, 2.0]),
        parameters=np.array([1, 1]),
        fun=simple_ode_forward_euler,
        num_states=2,
        v_index=0,
    )
    assert ode.num_points == V_ode.ndofs
    ode.to_dolfin()
    ode.ode_to_pde()
    assert np.allclose(v_pde.x.array, 1.0)
    v_pde.x.array[:] = 3.0
    ode.pde_to_ode()
    assert np.allclose(v_ode.x.array, 3.0)


def test_DolfinMultiODESolver():
    N = 5
    mesh = meshmod.create_unit_square(None, N, N)

    V_pde = fem.functionspace(mesh, ("P", 1))
    v_pde = fem.Function(V_pde)
    V_ode = fem.functionspace(mesh, ("P", 1))
    v_ode = fem.Function(V_ode)

    markers = fem.Function(V_ode)
    markers.interpolate(lambda x: np.where(x[0] < 0.5, 1.0, 2.0))

    first_v0, first_s0 = 1.0, 2.0
    second_v0, second_s0 = 3.0, 4.0
    init_states = {
        1: np.array([first_v0, first_s0]),
        2: np.array([second_v0, second_s0]),
    }
    first_p0, second_p0 = 1, 2
    parameters = {
        1: np.array([first_p0, first_p0]),
        2: np.array([second_p0, second_p0]),
    }
    N_ode = V_ode.ndofs

    ode = DolfinMultiODESolver(
        v_ode=v_ode,
        v_pde=v_pde,
        markers=markers,
        init_states=init_states,
        parameters=parameters,
        fun={1: simple_ode_forward_euler, 2: simple_ode_forward_euler},
        num_states={i: len(s) for i, s in init_states.items()},
        v_index={i: 0 for i in init_states.keys()},
    )

    assert ode.full_values.shape == (2, N_ode)
    assert ode.values(1).shape == (2, (markers.x.array == 1).sum())
    assert ode.values(2).shape == (2, (markers.x.array == 2).sum())
    assert np.allclose(ode.values(1)[0, :], first_v0)
    assert np.allclose(ode.values(2)[1, :], second_s0)

    dt = 0.1
    ode.step(0.0, dt)
    assert np.allclose(ode.values(1)[0, :], first_v0 - first_p0 * first_s0 * dt)
    assert np.allclose(ode.values(1)[1, :], first_s0 + first_p0 * first_v0 * dt)
    assert np.allclose(ode.values(2)[0, :], second_v0 - second_p0 * second_s0 * dt)
    assert np.allclose(ode.values(2)[1, :], second_s0 + second_p0 * second_v0 * dt)

    assert np.allclose(v_ode.x.array, 0.0)
    ode.to_dolfin()
    assert np.allclose(v_ode.x.array[markers.x.array == 1], first_v0 - first_p0 * first_s0 * dt)
    assert np.allclose(v_ode.x.array[markers.x.array == 2], second_v0 - second_p0 * second_s0 * dt)
    assert np.allclose(v_pde.x.array, 0.0)
    ode.ode_to_pde()
    assert np.allclose(v_pde.x.array[markers.x.array == 1], first_v0 - first_p0 * first_s0 * dt)
    assert np.allclose(v_pde.x.array[markers.x.array == 2], second_v0 - second_p0 * second_s0 * dt)
    v_pde.x.array[:] = 1.0
    ode.pde_to_ode()
    assert np.allclose(v_ode.x.array, 1.0)
    ode.from_dolfin()
    assert np.allclose(ode.values(1)[0, :], 1.0)
    assert np.allclose(ode.values(2)[0, :], 1.0)
    assert np.allclose(ode.values(1)[1, :], first_s0 + first_p0 * first_v0 * dt)
    assert np.allclose(ode.values(2)[1, :], second_s0 + second_p0 * second_v0 * dt)

    states = ode.states_to_dolfin()
    assert len(states) == 2
    assert np.allclose(states[0].x.array, 1.0)


def test_make_multi_ode_mixed_models():
    """Composed multi-marker step (make_multi_ode) reproduces each model's
    own trajectory on its nodes — including models with different state
    counts AND different voltage rows (TP06: 19 states, V at 0; FHN: 2
    states, v at 1)."""
    import jax.numpy as jnp

    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.odesolver import make_multi_ode

    n = 40
    rng = np.random.default_rng(3)
    markers = np.where(rng.random(n) < 0.5, 1, 2)

    fun = {1: tp06.generalized_rush_larsen, 2: fhn.generalized_rush_larsen}
    init = {1: tp06.init_state_values(), 2: fhn.init_state_values()}
    params = {
        1: tp06.init_parameter_values(stim_amplitude=0.0),
        2: fhn.init_parameter_values(),
    }
    v_index = {1: tp06.state_index("V"), 2: fhn.state_index("v")}

    ode_fun, union, masks, v_common = make_multi_ode(markers, fun, init, params, v_index)
    assert v_common == 0
    assert union.shape == (19, n)
    assert masks.shape == (2, n)

    # reference trajectories: each model stepped alone over all nodes
    dt, nsteps = 0.05, 20
    s1 = jnp.asarray(np.tile(np.asarray(init[1])[:, None], (1, n)))
    s2 = jnp.asarray(np.tile(np.asarray(init[2])[:, None], (1, n)))
    su = jnp.asarray(union)
    masks_j = jnp.asarray(masks)
    t = 0.0
    for _ in range(nsteps):
        s1 = fun[1](states=s1, t=t, parameters=jnp.asarray(params[1]), dt=dt)
        s2 = fun[2](states=s2, t=t, parameters=jnp.asarray(params[2]), dt=dt)
        su = ode_fun(states=su, t=t, parameters=masks_j, dt=dt)
        t += dt

    m1, m2 = masks[0], masks[1]
    # marker-1 nodes: all 19 rows match TP06 (stored with V swapped to 0)
    swap1 = np.arange(19)
    swap1[[0, v_index[1]]] = [v_index[1], 0]
    np.testing.assert_allclose(
        np.asarray(su)[:, m1], np.asarray(s1)[swap1][:, m1], rtol=1e-12, atol=1e-12
    )
    # marker-2 nodes: first 2 rows match FHN (v swapped to row 0)
    swap2 = np.array([1, 0])
    np.testing.assert_allclose(
        np.asarray(su)[:2, m2], np.asarray(s2)[swap2][:, m2], rtol=1e-12, atol=1e-12
    )


def test_multi_ode_composition_matches_separate_models():
    """The masked multi-marker composition steps each marker's nodes
    exactly as its own model would, with different state counts and
    voltage rows per model (TP06 and FHN)."""
    import jax.numpy as jnp

    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.odesolver import make_multi_ode

    n = 300
    markers = np.where(np.arange(n) < 130, 1, 2)
    fun = {1: tp06.generalized_rush_larsen, 2: fhn.generalized_rush_larsen}
    init = {1: tp06.init_state_values(), 2: fhn.init_state_values()}
    params = {
        1: tp06.init_parameter_values(stim_amplitude=0.0),
        2: fhn.init_parameter_values(),
    }
    v_index = {1: tp06.state_index("V"), 2: fhn.state_index("v")}
    ode_fun, union, masks, v_common = make_multi_ode(markers, fun, init, params, v_index)
    assert v_common == 0

    got = jnp.asarray(union)
    masks_j = jnp.asarray(masks, dtype=jnp.float64)
    sep = {m: np.tile(init[m][:, None], (1, int((markers == m).sum()))) for m in (1, 2)}
    dt, t = 0.05, 0.0
    for _ in range(5):
        got = ode_fun(states=got, t=t, parameters=masks_j, dt=dt)
        for m in (1, 2):
            sep[m] = np.asarray(fun[m](sep[m], t, params[m], dt))
        t += dt
    got = np.asarray(got)
    for m in (1, 2):
        S_m = init[m].shape[0]
        swap = np.arange(S_m)
        swap[[0, v_index[m]]] = [v_index[m], 0]  # stored with v in row 0
        np.testing.assert_allclose(
            got[:S_m, markers == m][swap], sep[m], rtol=1e-12, atol=1e-12
        )
