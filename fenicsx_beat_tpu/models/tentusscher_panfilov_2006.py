"""ten Tusscher & Panfilov (2006) human ventricular cell model (epi variant).

Implemented from the published model (K.H.W.J. ten Tusscher, A.V. Panfilov,
"Alternans and spiral breakup in a human ventricular tissue model", Am J
Physiol Heart Circ Physiol 291:H1088-H1100, 2006).  Replaces the
gotranx-generated code the reference compiles at demo runtime
(``demos/niederer_benchmark.py:75-88``); exposes the same contract:
``init_state_values`` / ``init_parameter_values`` / ``state_index`` /
``parameter_index`` / ``generalized_rush_larsen`` / ``forward_euler``.

Accelerator-first formulation: the stepper is a pure jnp function over a
``(19, n_points)`` state array — one elementwise expression per step
(no per-cell loops), safe under ``jit``/``vmap``/``lax.scan`` and
dtype-polymorphic (f64 CPU validation, f32 production).  The 12 gate
variables use the exact Rush-Larsen exponential update; the singular
L-type Ca driving-force term uses an ``expm1``-guarded form, and ``celltype``
(0=endo, 1=epi, 2=mid) switches the published transmural parameter sets.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_STATE_NAMES = [
    "V",
    "Xr1",
    "Xr2",
    "Xs",
    "m",
    "h",
    "j",
    "d",
    "f",
    "f2",
    "fCass",
    "s",
    "r",
    "Ca_i",
    "R_prime",
    "Ca_SR",
    "Ca_ss",
    "Na_i",
    "K_i",
]

# Published steady-ish initial values (epi), matching the Niederer benchmark
# initial conditions (reference demos/niederer_benchmark.py:37-60).
_DEFAULT_STATES = {
    "V": -85.23,
    "Xr1": 0.00621,
    "Xr2": 0.4712,
    "Xs": 0.0095,
    "m": 0.00172,
    "h": 0.7444,
    "j": 0.7045,
    "d": 3.373e-5,
    "f": 0.7888,
    "f2": 0.9755,
    "fCass": 0.9953,
    "s": 0.999998,
    "r": 2.42e-8,
    "Ca_i": 0.000126,
    "R_prime": 0.9073,
    "Ca_SR": 3.64,
    "Ca_ss": 0.00036,
    "Na_i": 8.604,
    "K_i": 136.89,
}

_PARAM_DEFAULTS = [
    # name, value
    ("P_kna", 0.03),
    ("g_K1", 5.405),
    ("g_Kr", 0.153),
    ("g_Ks", 0.392),  # epi; endo 0.392, mid 0.098
    ("g_Na", 14.838),
    ("g_bna", 0.00029),
    ("g_CaL", 0.0398),
    ("g_bca", 0.000592),
    ("g_to", 0.294),  # epi/mid; endo 0.073
    ("P_NaK", 2.724),
    ("K_mk", 1.0),
    ("K_mNa", 40.0),
    ("K_NaCa", 1000.0),
    ("K_sat", 0.1),
    ("alpha", 2.5),
    ("gamma", 0.35),
    ("Km_Ca", 1.38),
    ("Km_Nai", 87.5),
    ("g_pCa", 0.1238),
    ("K_pCa", 0.0005),
    ("g_pK", 0.0146),
    ("Ca_o", 2.0),
    ("k1_prime", 0.15),
    ("k2_prime", 0.045),
    ("k3", 0.06),
    ("k4", 0.005),
    ("EC", 1.5),
    ("max_sr", 2.5),
    ("min_sr", 1.0),
    ("V_rel", 0.102),
    ("V_xfer", 0.0038),
    ("K_up", 0.00025),
    ("V_leak", 0.00036),
    ("Vmax_up", 0.006375),
    ("Buf_c", 0.2),
    ("K_buf_c", 0.001),
    ("Buf_sr", 10.0),
    ("K_buf_sr", 0.3),
    ("Buf_ss", 0.4),
    ("K_buf_ss", 0.00025),
    ("V_sr", 1094.0),
    ("V_ss", 54.68),
    ("Na_o", 140.0),
    ("R", 8.314),
    ("T", 310.0),
    ("F", 96.485),
    ("Cm", 185.0),
    ("V_c", 16404.0),
    ("stim_start", 10.0),
    ("stim_period", 1000.0),
    ("stim_duration", 1.0),
    ("stim_amplitude", -52.0),
    ("K_o", 5.4),
    ("celltype", 1.0),  # 0=endo, 1=epi, 2=mid
]

_PARAM_NAMES = [n for n, _ in _PARAM_DEFAULTS]


def state_index(name: str) -> int:
    return _STATE_NAMES.index(name)


def parameter_index(name: str) -> int:
    return _PARAM_NAMES.index(name)


def init_state_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_STATE_NAMES)
    if unknown:
        raise KeyError(f"Unknown state name(s): {sorted(unknown)}")
    vals = dict(_DEFAULT_STATES)
    vals.update(overrides)
    return np.array([vals[n] for n in _STATE_NAMES], dtype=np.float64)


def init_parameter_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_PARAM_NAMES)
    if unknown:
        raise KeyError(f"Unknown parameter name(s): {sorted(unknown)}")
    vals = dict(_PARAM_DEFAULTS)
    vals.update(overrides)
    return np.array([vals[n] for n in _PARAM_NAMES], dtype=np.float64)


def _unpack_params(parameters):
    return {name: parameters[i] for i, (name, _) in enumerate(_PARAM_DEFAULTS)}


def _gate_rates(V, p, xp=jnp):
    """(x_inf, tau) for the 11 Hodgkin-Huxley gates that depend on V only
    (fCass, which gates on Ca_ss, lives in :func:`_currents_and_gates`).

    ``xp`` selects the array namespace: ``jnp`` on the solve path, ``numpy``
    when :func:`tabulated_rush_larsen` samples these rates onto a host grid.
    """
    exp = xp.exp
    sqrt = xp.sqrt
    where = xp.where

    ct = p["celltype"]
    is_endo = ct == 0

    # rapid delayed rectifier
    xr1_inf = 1 / (1 + exp((-26 - V) / 7))
    tau_xr1 = (450 / (1 + exp((-45 - V) / 10))) * (6 / (1 + exp((V + 30) / 11.5)))
    xr2_inf = 1 / (1 + exp((V + 88) / 24))
    tau_xr2 = (3 / (1 + exp((-60 - V) / 20))) * (1.12 / (1 + exp((V - 60) / 20)))

    # slow delayed rectifier
    xs_inf = 1 / (1 + exp((-5 - V) / 14))
    tau_xs = (1400 / sqrt(1 + exp((5 - V) / 6))) * (1 / (1 + exp((V - 35) / 15))) + 80

    # fast sodium
    m_inf = 1 / (1 + exp((-56.86 - V) / 9.03)) ** 2
    tau_m = (1 / (1 + exp((-60 - V) / 5))) * (
        0.1 / (1 + exp((V + 35) / 5)) + 0.1 / (1 + exp((V - 50) / 200))
    )
    h_inf = 1 / (1 + exp((V + 71.55) / 7.43)) ** 2
    a_h = where(V < -40, 0.057 * exp(-(V + 80) / 6.8), 0.0)
    b_h = where(
        V < -40,
        2.7 * exp(0.079 * V) + 310000 * exp(0.3485 * V),
        0.77 / (0.13 * (1 + exp((V + 10.66) / -11.1))),
    )
    tau_h = 1 / (a_h + b_h)
    j_inf = h_inf
    a_j = where(
        V < -40,
        (-25428 * exp(0.2444 * V) - 6.948e-6 * exp(-0.04391 * V))
        * (V + 37.78)
        / (1 + exp(0.311 * (V + 79.23))),
        0.0,
    )
    b_j = where(
        V < -40,
        0.02424 * exp(-0.01052 * V) / (1 + exp(-0.1378 * (V + 40.14))),
        0.6 * exp(0.057 * V) / (1 + exp(-0.1 * (V + 32))),
    )
    tau_j = 1 / (a_j + b_j)

    # L-type Ca voltage gates
    d_inf = 1 / (1 + exp((-8 - V) / 7.5))
    tau_d = (1.4 / (1 + exp((-35 - V) / 13)) + 0.25) * (1.4 / (1 + exp((V + 5) / 5))) + 1 / (
        1 + exp((50 - V) / 20)
    )
    f_inf = 1 / (1 + exp((V + 20) / 7))
    tau_f = (
        1102.5 * exp(-((V + 27) ** 2) / 225)
        + 200 / (1 + exp((13 - V) / 10))
        + 180 / (1 + exp((V + 30) / 10))
        + 20
    )
    f2_inf = 0.67 / (1 + exp((V + 35) / 7)) + 0.33
    tau_f2 = (
        562 * exp(-((V + 27) ** 2) / 240)
        + 31 / (1 + exp((25 - V) / 10))
        + 80 / (1 + exp((V + 30) / 10))
    )

    # transient outward; endo uses different s_inf/tau_s (published
    # transmural difference)
    s_inf_epi = 1 / (1 + exp((V + 20) / 5))
    s_inf_endo = 1 / (1 + exp((V + 28) / 5))
    s_inf = where(is_endo, s_inf_endo, s_inf_epi)
    tau_s_epi = 85 * exp(-((V + 45) ** 2) / 320) + 5 / (1 + exp((V - 20) / 5)) + 3
    tau_s_endo = 1000 * exp(-((V + 67) ** 2) / 1000) + 8
    tau_s = where(is_endo, tau_s_endo, tau_s_epi)
    r_inf = 1 / (1 + exp((20 - V) / 6))
    tau_r = 9.5 * exp(-((V + 40) ** 2) / 1800) + 0.8

    return {
        "Xr1": (xr1_inf, tau_xr1),
        "Xr2": (xr2_inf, tau_xr2),
        "Xs": (xs_inf, tau_xs),
        "m": (m_inf, tau_m),
        "h": (h_inf, tau_h),
        "j": (j_inf, tau_j),
        "d": (d_inf, tau_d),
        "f": (f_inf, tau_f),
        "f2": (f2_inf, tau_f2),
        "s": (s_inf, tau_s),
        "r": (r_inf, tau_r),
    }


def _k1_xinf(u, xp=jnp):
    """Inward-rectifier open fraction as a function of u = V - E_K."""
    exp = xp.exp
    a_K1 = 0.1 / (1 + exp(0.06 * (u - 200)))
    b_K1 = (3 * exp(0.0002 * (u + 100)) + exp(0.1 * (u - 10))) / (1 + exp(-0.5 * u))
    return a_K1 / (a_K1 + b_K1)


def _v_current_factors(V, p, xp=jnp):
    """The V-only transcendental factors of the pump/exchanger/CaL currents.

    Grouped so the currents assemble as products with the dynamic
    concentrations (see :func:`_currents_and_derivs`):

    - ``i_CaL  = d*f*f2*fCass * (Ca_ss * caL1 - caL2)``
    - ``i_NaK  = naK * Na_i / (Na_i + K_mNa)``
    - ``i_NaCa = naCa1 * Na_i**3 - naCa2 * Ca_i``
    - ``i_p_K  = g_pK * (V - E_K) * pK``
    """
    exp = xp.exp
    where = xp.where
    RTF = p["R"] * p["T"] / p["F"]
    VFRT = V / RTF

    # L-type Ca driving force (expm1-guarded singular term at V = 15 mV);
    # exp(x)-1 instead of expm1 (plain exp lowers in every kernel route) — the small-|x|
    # branch uses the series, so cancellation near 0 is irrelevant
    x = 2 * (V - 15) * (1.0 / RTF)
    ex = exp(x)
    ex1 = ex - 1.0
    xg = where(xp.abs(x) < 1e-7, 1.0 - 0.5 * x, x / where(xp.abs(ex1) < 1e-30, 1.0, ex1))
    caL1 = p["g_CaL"] * 2 * p["F"] * 0.25 * ex * xg
    caL2 = p["g_CaL"] * 2 * p["F"] * p["Ca_o"] * xg

    naK = (
        p["P_NaK"]
        * p["K_o"]
        / (p["K_o"] + p["K_mk"])
        / (1 + 0.1245 * exp(-0.1 * VFRT) + 0.0353 * exp(-VFRT))
    )

    denom = (
        (p["Km_Nai"] ** 3 + p["Na_o"] ** 3)
        * (p["Km_Ca"] + p["Ca_o"])
    )
    e2 = exp((p["gamma"] - 1) * VFRT)
    sat = 1 + p["K_sat"] * e2
    naCa1 = p["K_NaCa"] * p["Ca_o"] * exp(p["gamma"] * VFRT) / (denom * sat)
    naCa2 = p["K_NaCa"] * p["Na_o"] ** 3 * p["alpha"] * e2 / (denom * sat)

    pK = 1 / (1 + exp((25 - V) / 5.98))

    return {"caL1": caL1, "caL2": caL2, "naK": naK, "naCa1": naCa1, "naCa2": naCa2, "pK": pK}


def _currents_and_derivs(states, t, p, fac, k1_of_u, xp=jnp):
    """All ionic currents and the non-gate state derivatives, given the
    V-only factors ``fac`` (:func:`_v_current_factors`, either exact or
    table-interpolated) and ``k1_of_u``, a callable mapping u = V - E_K to
    the inward-rectifier open fraction (:func:`_k1_xinf` or its table)."""
    (
        V,
        Xr1,
        Xr2,
        Xs,
        m,
        h,
        j,
        d,
        f,
        f2,
        fCass,
        s,
        r,
        Ca_i,
        R_prime,
        Ca_SR,
        Ca_ss,
        Na_i,
        K_i,
    ) = (states[i] for i in range(19))

    log = xp.log
    sqrt = xp.sqrt
    where = xp.where

    RTF = p["R"] * p["T"] / p["F"]

    # transmural parameter switches (published endo/epi/mid differences)
    ct = p["celltype"]
    is_endo = ct == 0
    is_mid = ct == 2
    g_Ks = where(is_mid, 0.098, p["g_Ks"])
    g_to = where(is_endo, 0.073, p["g_to"])

    # reversal potentials
    E_Na = RTF * log(p["Na_o"] / Na_i)
    E_K = RTF * log(p["K_o"] / K_i)
    E_Ks = RTF * log((p["K_o"] + p["P_kna"] * p["Na_o"]) / (K_i + p["P_kna"] * Na_i))
    E_Ca = 0.5 * RTF * log(p["Ca_o"] / Ca_i)

    i_K1 = p["g_K1"] * k1_of_u(V - E_K) * sqrt(p["K_o"] / 5.4) * (V - E_K)
    i_Kr = p["g_Kr"] * sqrt(p["K_o"] / 5.4) * Xr1 * Xr2 * (V - E_K)
    i_Ks = g_Ks * Xs**2 * (V - E_Ks)
    i_Na = p["g_Na"] * m**3 * h * j * (V - E_Na)
    i_b_Na = p["g_bna"] * (V - E_Na)
    i_CaL = d * f * f2 * fCass * (Ca_ss * fac["caL1"] - fac["caL2"])
    i_b_Ca = p["g_bca"] * (V - E_Ca)
    i_to = g_to * r * s * (V - E_K)
    i_NaK = fac["naK"] * Na_i / (Na_i + p["K_mNa"])
    i_NaCa = fac["naCa1"] * Na_i**3 - fac["naCa2"] * Ca_i
    i_p_Ca = p["g_pCa"] * Ca_i / (Ca_i + p["K_pCa"])
    i_p_K = p["g_pK"] * (V - E_K) * fac["pK"]

    # calcium dynamics fluxes
    i_up = p["Vmax_up"] / (1 + p["K_up"] ** 2 / Ca_i**2)
    i_leak = p["V_leak"] * (Ca_SR - Ca_i)
    i_xfer = p["V_xfer"] * (Ca_ss - Ca_i)
    kcasr = p["max_sr"] - (p["max_sr"] - p["min_sr"]) / (1 + (p["EC"] / Ca_SR) ** 2)
    k1 = p["k1_prime"] / kcasr
    k2 = p["k2_prime"] * kcasr
    O = k1 * Ca_ss**2 * R_prime / (p["k3"] + k1 * Ca_ss**2)
    i_rel = p["V_rel"] * O * (Ca_SR - Ca_ss)

    # periodic pacing stimulus (0 in tissue mode)
    t_in_period = t - xp.floor(t / p["stim_period"]) * p["stim_period"]
    i_Stim = where(
        (t_in_period >= p["stim_start"]) & (t_in_period <= p["stim_start"] + p["stim_duration"]),
        p["stim_amplitude"],
        0.0,
    )

    # non-gate derivatives
    CmF = p["Cm"] / (p["V_c"] * p["F"])
    f_free_i = 1 / (1 + p["Buf_c"] * p["K_buf_c"] / (Ca_i + p["K_buf_c"]) ** 2)
    f_free_sr = 1 / (1 + p["Buf_sr"] * p["K_buf_sr"] / (Ca_SR + p["K_buf_sr"]) ** 2)
    f_free_ss = 1 / (1 + p["Buf_ss"] * p["K_buf_ss"] / (Ca_ss + p["K_buf_ss"]) ** 2)

    dCa_i = (
        -(i_b_Ca + i_p_Ca - 2 * i_NaCa) * CmF / 2
        + (i_leak - i_up) * p["V_sr"] / p["V_c"]
        + i_xfer
    ) * f_free_i
    dR_prime = -k2 * Ca_ss * R_prime + p["k4"] * (1 - R_prime)
    dCa_SR = (i_up - (i_rel + i_leak)) * f_free_sr
    dCa_ss = (
        -i_CaL * p["Cm"] / (2 * p["V_ss"] * p["F"])
        + i_rel * p["V_sr"] / p["V_ss"]
        - i_xfer * p["V_c"] / p["V_ss"]
    ) * f_free_ss
    dNa_i = -(i_Na + i_b_Na + 3 * i_NaK + 3 * i_NaCa) * CmF
    dV = -(
        i_K1
        + i_to
        + i_Kr
        + i_Ks
        + i_CaL
        + i_NaK
        + i_Na
        + i_b_Na
        + i_NaCa
        + i_b_Ca
        + i_p_K
        + i_p_Ca
        + i_Stim
    )
    dK_i = -(i_K1 + i_to + i_Kr + i_Ks + i_p_K + i_Stim - 2 * i_NaK) * CmF

    nongates = {
        "V": dV,
        "Ca_i": dCa_i,
        "R_prime": dR_prime,
        "Ca_SR": dCa_SR,
        "Ca_ss": dCa_ss,
        "Na_i": dNa_i,
        "K_i": dK_i,
    }
    # exponential-update data for R_prime (linear ODE in R_prime):
    # dR'/dt = k4 - (k2*Ca_ss + k4) R'
    rp_rate = k2 * Ca_ss + p["k4"]
    rp_inf = p["k4"] / rp_rate
    return nongates, (rp_inf, rp_rate)


def _fcass_rates(Ca_ss, xp=jnp):
    """(fCass_inf, tau_fCass) — functions of y = 1/(1+(Ca_ss/0.05)^2)."""
    y = 1 / (1 + (Ca_ss / 0.05) ** 2)
    return 0.6 * y + 0.4, 80 * y + 2


def _currents_and_gates(states, t, p, xp=jnp):
    """All ionic currents, gate (x_inf, tau) pairs and concentration fluxes
    (exact transcendental evaluation — the solve path).  ``xp`` follows
    the module convention; passing :data:`~..ops.fastmath.FASTEXP_XP`
    swaps every ``exp`` for the bit-trick variant."""
    V = states[0]
    Ca_ss = states[16]
    gates = dict(_gate_rates(V, p, xp=xp))
    gates["fCass"] = _fcass_rates(Ca_ss, xp=xp)
    fac = _v_current_factors(V, p, xp=xp)
    k1 = lambda u: _k1_xinf(u, xp=xp)  # noqa: E731
    nongates, rp = _currents_and_derivs(states, t, p, fac, k1, xp=xp)
    return gates, nongates, rp


def rhs(states, t, parameters):
    """Full right-hand side: d(states)/dt, shape (19, n)."""
    p = _unpack_params(parameters)
    gates, nongates, _ = _currents_and_gates(states, t, p)
    out = []
    for i, name in enumerate(_STATE_NAMES):
        if name in gates:
            x_inf, tau = gates[name]
            out.append((x_inf - states[i]) / tau)
        else:
            out.append(nongates[name])
    return jnp.stack(out)


def forward_euler(states, t, parameters, dt, **kwargs):
    states = jnp.asarray(states)
    return states + dt * rhs(states, t, parameters)


def generalized_rush_larsen(states, t, parameters, dt, xp=jnp, **kwargs):
    """Generalized Rush-Larsen step (the scheme the reference requests from
    gotranx, ``demos/niederer_benchmark.py:82-86``): exact exponential
    update for the 12 Hodgkin-Huxley gates and the linear R_prime ODE,
    explicit update for V and the concentrations.  ``xp=FASTEXP_XP``
    (:mod:`..ops.fastmath`) swaps the ~58 exp/node for the bit-trick
    variant; ``xp=numpy`` evaluates the step in plain NumPy (the float64
    host reference of the on-device step)."""
    states = xp.asarray(states)
    p = _unpack_params(parameters)
    gates, nongates, (rp_inf, rp_rate) = _currents_and_gates(
        states, t, p, xp=xp
    )
    out = []
    for i, name in enumerate(_STATE_NAMES):
        x = states[i]
        if name in gates:
            x_inf, tau = gates[name]
            out.append(x_inf + (x - x_inf) * xp.exp(-dt / tau))
        elif name == "R_prime":
            out.append(rp_inf + (x - rp_inf) * xp.exp(-dt * rp_rate))
        else:
            out.append(x + dt * nongates[name])
    return xp.stack(out)


_GATE_ORDER = ["Xr1", "Xr2", "Xs", "m", "h", "j", "d", "f", "f2", "s", "r"]
_N_FCASS = 128  # table size for the fCass relaxation factor in y in [0, 1]


def _interp_tables(pair, i0, frac):
    """Piecewise-linear table read: ``base[i0] + frac * delta[i0]``."""
    base, delta = pair
    return jnp.take(base, i0) + frac * jnp.take(delta, i0)


def _as_pair(fine_vals):
    """(base, delta) interpolation pair from sampled f64 values."""
    base = np.asarray(fine_vals, dtype=np.float64)
    delta = np.empty_like(base)
    delta[:-1] = base[1:] - base[:-1]
    delta[-1] = 0.0
    return base, delta


def tabulated_rush_larsen(
    dt,
    parameters=None,
    n_entries=256,
    v_range=(-105.0, 62.0),
    u_range=(-40.0, 170.0),
    dtype=np.float32,
):
    """Build a table-driven :func:`generalized_rush_larsen` with ``dt`` baked.

    The classic cardiac-simulation optimization (used by ten Tusscher's own
    published C code): every transcendental that depends on V alone — the
    (x_inf, tau) pairs of the 11 voltage gates, the CaL driving-force pair,
    the NaK/NaCa exponentials, the p_K rectification, and the K1 open
    fraction in u = V - E_K — is sampled once on a host grid and replaced by
    piecewise-linear table reads (gathers), cutting the exp census of a
    step from ~58 to 1 (the R_prime rate, which depends on Ca_SR*Ca_ss).
    fCass, a function of Ca_ss, keeps its exact algebraic x_inf and reads
    exp(-dt/tau) from a table in y = 1/(1+(Ca_ss/0.05)^2).

    The production solvers use the exact :func:`generalized_rush_larsen`;
    this variant is off the main path: a build-time-audited accuracy
    baseline and an option where transcendentals are expensive.

    Accuracy: tables are sampled in float64 and interpolated linearly; with
    the default 256 entries over 167 mV the worst-case gate-coefficient
    error is ~1e-3 (dominated by exp(-dt/tau_m) where tau_m is steepest) —
    measured against the exact step in ``tests/test_models.py`` and against
    the Niederer activation gates in the benchmark.  Build-time max
    interpolation errors per table are exposed as ``fun.table_error``.

    The returned ``fun(states, t, parameters=None, dt=None)`` has the
    standard model contract but IGNORES the runtime ``parameters``/``dt``
    (both are baked); ``fun.fixed_dt`` carries the baked step so solvers can
    validate.  Use one instance per distinct ionic sub-step (theta*dt).
    """
    dt = float(dt)
    params = init_parameter_values() if parameters is None else np.asarray(parameters, np.float64)
    p = {name: float(params[i]) for i, (name, _) in enumerate(_PARAM_DEFAULTS)}

    v0, v1 = map(float, v_range)
    u0, u1 = map(float, u_range)
    vg = np.linspace(v0, v1, n_entries)
    ug = np.linspace(u0, u1, n_entries)
    yg = np.linspace(0.0, 1.0, _N_FCASS)

    gate_rates = _gate_rates(vg, p, xp=np)
    gate_tabs = {}
    for name in _GATE_ORDER:
        x_inf, tau = gate_rates[name]
        gate_tabs[name] = (_as_pair(x_inf), _as_pair(np.exp(-dt / tau)))
    fac_vals = _v_current_factors(vg, p, xp=np)
    fac_tabs = {k: _as_pair(v) for k, v in fac_vals.items()}
    k1_tab = _as_pair(_k1_xinf(ug, xp=np))
    Bfc_tab = _as_pair(np.exp(-dt / (80.0 * yg + 2.0)))

    # build-time audit: max |linear interp - exact| on an 8x finer grid
    table_error = {}
    vf = np.linspace(v0, v1, 8 * n_entries - 7)
    fine_rates = _gate_rates(vf, p, xp=np)
    fine_fac = _v_current_factors(vf, p, xp=np)

    def _lin(base):
        u = (vf - v0) / (v1 - v0) * (n_entries - 1)
        i = np.minimum(u.astype(int), n_entries - 2)
        return base[i] + (u - i) * (base[i + 1] - base[i])

    for name in _GATE_ORDER:
        xi_f, tau_f = fine_rates[name]
        table_error[f"A_{name}"] = float(np.max(np.abs(_lin(gate_tabs[name][0][0]) - xi_f)))
        table_error[f"B_{name}"] = float(
            np.max(np.abs(_lin(gate_tabs[name][1][0]) - np.exp(-dt / tau_f)))
        )
    for k in fac_tabs:
        scale = max(1.0, float(np.max(np.abs(fine_fac[k]))))
        table_error[k] = float(np.max(np.abs(_lin(fac_tabs[k][0]) - fine_fac[k]))) / scale

    tables = {}
    for name in _GATE_ORDER:
        tables["A_" + name] = gate_tabs[name][0]
        tables["B_" + name] = gate_tabs[name][1]
    tables.update(fac_tabs)
    tables["K1"] = k1_tab
    tables["Bfc"] = Bfc_tab
    tables = {
        k: tuple(np.asarray(a, dtype=np.float64).astype(dtype) for a in pair)
        for k, pair in tables.items()
    }

    inv_dv = (n_entries - 1) / (v1 - v0)
    inv_du = (n_entries - 1) / (u1 - u0)
    dt_baked = dt

    def _index(x, x0, inv_dx, n):
        u = jnp.clip((x - x0) * inv_dx, 0.0, n - 1 - 1e-4)
        i0 = u.astype(jnp.int32)
        return i0, u - i0.astype(u.dtype)

    gate_names = set(_GATE_ORDER)

    def fun(states, t=0.0, parameters=None, dt=None, **kwargs):
        del parameters, dt  # baked at build time

        def pair(name):
            return tuple(jnp.asarray(a) for a in tables[name])

        V = states[0]
        Ca_ss = states[16]

        iv, fv = _index(V, v0, inv_dv, n_entries)
        fac = {k: _interp_tables(pair(k), iv, fv) for k in fac_tabs}

        def k1_of_u(u):
            iu, fu = _index(u, u0, inv_du, n_entries)
            return _interp_tables(pair("K1"), iu, fu)

        nongates, (rp_inf, rp_rate) = _currents_and_derivs(
            states, t, p, fac, k1_of_u, xp=jnp
        )

        y = 1 / (1 + (Ca_ss / 0.05) ** 2)
        iy, fy = _index(y, 0.0, float(_N_FCASS - 1), _N_FCASS)
        fCass_A = 0.6 * y + 0.4
        fCass_B = _interp_tables(pair("Bfc"), iy, fy)

        out = []
        for i, name in enumerate(_STATE_NAMES):
            x = states[i]
            if name in gate_names:
                A = _interp_tables(pair("A_" + name), iv, fv)
                B = _interp_tables(pair("B_" + name), iv, fv)
                out.append(A + (x - A) * B)
            elif name == "fCass":
                out.append(fCass_A + (x - fCass_A) * fCass_B)
            elif name == "R_prime":
                out.append(rp_inf + (x - rp_inf) * jnp.exp(-dt_baked * rp_rate))
            else:
                out.append(x + dt_baked * nongates[name])
        return jnp.stack(out)

    fun.fixed_dt = dt
    fun.table_error = table_error
    fun.n_entries = n_entries
    fun.v_range = (v0, v1)
    fun.__name__ = "tabulated_rush_larsen_step"
    return fun
