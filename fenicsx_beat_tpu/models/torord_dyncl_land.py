"""ToR-ORd dynCl coupled to the Land (2017) human contraction model.

Implemented from the published models (Tomek et al. eLife 2019 dynCl
variant + S. Land et al., "A model of cardiac contraction based on novel
measurements of tension development in human cardiomyocytes", JMCC 106,
2017).  Replaces the gotranx pipeline the reference applies to
``odes/torord/ToRORd_dynCl_endo_Land.ode``; same module contract as the
other in-repo ionic models.

Differences vs plain dynCl (mirroring the reference's Land .ode variant):
7 mechanics states (XS, XW, CaTrpn, TmB, Zetas, Zetaw, Cd); troponin
calcium buffering moves from the instantaneous Bcai term into the CaTrpn
ODE (J_TRPN), with the variant's published dcai form; ``lmbda`` /
``dLambda`` parameters couple the sarcomere stretch; ``active_tension``
returns the Land active + passive tension (Ta, Tp, Ttot).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from . import torord_dyncl as _base

_MECH_STATE_NAMES = ["XS", "XW", "CaTrpn", "TmB", "Zetas", "Zetaw", "Cd"]
_STATE_NAMES = _base._STATE_NAMES + _MECH_STATE_NAMES

_DEFAULT_STATES = dict(_base._DEFAULT_STATES)
_DEFAULT_STATES.update(
    {
        # the Land .ode variant re-initializes cai at 1e-4
        "cai": 0.0001,
        "XS": 0.0,
        "XW": 0.0,
        "CaTrpn": 1e-8,
        "TmB": 1.0,
        "Zetas": 0.0,
        "Zetaw": 0.0,
        "Cd": 0.0,
    }
)

_MECH_PARAM_DEFAULTS = [
    ("emcoupling", 1.0),
    ("lmbda", 1.0),
    ("dLambda", 0.0),
    ("mode", 1.0),
    ("isacs", 0.0),
    ("calib", 1.0),
    ("ktrpn", 0.1),
    ("ntrpn", 2.0),
    ("Trpn50", 0.35),
    ("rw", 0.5),
    ("rs", 0.25),
    ("gammas", 0.0085),
    ("gammaw", 0.615),
    ("phi", 2.23),
    ("Tot_A", 25.0),
    ("Beta0", 2.3),
    ("Beta1", -2.4),
    ("cat50_ref", 0.805),
    ("Tref", 120.0),
    ("kuw", 0.182),
    ("kws", 0.012),
    ("ku", 0.04),
    ("ntm", 2.4),
    ("p_a", 2.1),
    ("p_b", 9.1),
    ("p_k", 7.0),
    ("etal", 200.0),
    ("etas", 20.0),
]

_PARAM_DEFAULTS = _base._PARAM_DEFAULTS + _MECH_PARAM_DEFAULTS
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
    return {name: parameters[i] for i, name in enumerate(_PARAM_NAMES)}


def _mechanics(s, p):
    """Land model rates: per-state (x_inf, rate) linear pairs + dcai
    correction terms.  Follows the published Land equations as mirrored in
    ``odes/torord/ToRORd_dynCl_endo_Land.ode`` (mechanics blocks)."""
    where, exp = jnp.where, jnp.exp
    kuw, kws, ku = p["kuw"], p["kws"], p["ku"]
    rw, rs = p["rw"], p["rs"]
    kwu = kuw * (1.0 / rw - 1.0) - kws
    ksu = kws * rw * (1.0 / rs - 1.0)
    Aw = p["Tot_A"] * rs / ((1.0 - rs) * rw + rs)
    As = Aw
    cw = p["phi"] * kuw * ((1.0 - rs) * (1.0 - rw)) / ((1.0 - rs) * rw)
    cs = p["phi"] * kws * ((1.0 - rs) * rw) / rs

    lam = jnp.minimum(p["lmbda"], 1.2)
    XS = jnp.maximum(s["XS"], 0.0)
    XW = jnp.maximum(s["XW"], 0.0)
    CaTrpn = jnp.maximum(s["CaTrpn"], 0.0)
    XU = (1.0 - s["TmB"]) - s["XS"] - s["XW"]

    gammawu = p["gammaw"] * jnp.abs(s["Zetaw"])
    # distortion-dependent detachment: |Zetas| above 0 or below -1
    zs_pos = where(s["Zetas"] > 0.0, s["Zetas"], 0.0)
    zs_neg = where(s["Zetas"] < -1.0, -s["Zetas"] - 1.0, 0.0)
    gammasu = p["gammas"] * jnp.maximum(zs_pos, zs_neg)

    cat50 = p["cat50_ref"] + p["Beta1"] * (lam - 1.0)
    catn = (s["cai"] * 1000.0 / cat50) ** p["ntrpn"]
    kb = ku * p["Trpn50"] ** p["ntm"] / (1.0 - rs - (1.0 - rs) * rw)
    unbind = jnp.minimum(CaTrpn ** (-p["ntm"] / 2.0), 100.0)
    bind = CaTrpn ** (p["ntm"] / 2.0)

    # linear (x' = b - a*x) forms, diagonal in each state:
    linear = {
        # dXS = kws*XW - (ksu + gammasu)*XS
        "XS": (kws * s["XW"] / (ksu + gammasu), ksu + gammasu),
        # dXW = kuw*(1-TmB-XS) - (kuw + kwu + kws + gammawu)*XW
        "XW": (
            kuw * (1.0 - s["TmB"] - s["XS"]) / (kuw + kwu + kws + gammawu),
            kuw + kwu + kws + gammawu,
        ),
        # dCaTrpn = ktrpn*(catn*(1-CaTrpn) - CaTrpn)
        "CaTrpn": (catn / (catn + 1.0), p["ktrpn"] * (catn + 1.0)),
        # dTmB = kb*unbind*(1-TmB-XS-XW) - ku*bind*TmB
        "TmB": (
            kb * unbind * (1.0 - s["XS"] - s["XW"]) / (kb * unbind + ku * bind),
            kb * unbind + ku * bind,
        ),
        "Zetas": (As * p["dLambda"] / cs, cs * jnp.ones_like(s["Zetas"])),
        "Zetaw": (Aw * p["dLambda"] / cw, cw * jnp.ones_like(s["Zetaw"])),
    }
    # Cd relaxes toward C = lam - 1 with state-dependent viscosity
    C = lam - 1.0
    dCd = C - s["Cd"]
    eta = where(dCd < 0.0, p["etas"], p["etal"])
    linear["Cd"] = (C, p["p_k"] / eta)

    dCaTrpn = p["ktrpn"] * (catn * (1.0 - s["CaTrpn"]) - s["CaTrpn"])
    J_TRPN = dCaTrpn * p["trpnmax"]
    return linear, J_TRPN


def _compute(states, t, p):
    s = {name: states[i] for i, name in enumerate(_STATE_NAMES)}
    base_states = states[: len(_base._STATE_NAMES)]
    gates, linear, explicit, aux = _base._compute(base_states, t, p)

    mech_linear, J_TRPN = _mechanics(s, p)
    linear = dict(linear)
    linear.update(mech_linear)

    # Land-variant dcai (troponin buffering via CaTrpn; published form of
    # the coupled .ode, including its INaCa_i/3 weighting and no ICaL_i):
    Bcai = 1.0 / (
        1.0 + aux["cmdnmax"] * p["kmcmdn"] / (p["kmcmdn"] + s["cai"]) ** 2.0
    )
    dcai = Bcai * (
        -(aux["IpCa"] + aux["ICab"] - 2.0 * aux["INaCa_i"] / 3.0)
        * aux["Acap"]
        / (2.0 * p["F"] * aux["vmyo"])
        - aux["Jup"] * aux["vnsr"] / aux["vmyo"]
        + aux["Jdiff"] * aux["vss"] / aux["vmyo"]
        - J_TRPN
    )
    explicit = dict(explicit)
    explicit["cai"] = dcai
    return gates, linear, explicit


def active_tension(states, parameters):
    """Land active/passive tension (Ta, Tp, Ttot) from the current state."""
    p = _unpack_params(parameters)
    s = {name: states[i] for i, name in enumerate(_STATE_NAMES)}
    lam = jnp.minimum(p["lmbda"], 1.2)
    lam087 = jnp.minimum(lam, 0.87)
    h_prima = 1.0 + p["Beta0"] * (lam + lam087 - 1.87)
    h_lambda = jnp.maximum(h_prima, 0.0)
    Ta = h_lambda * (p["Tref"] / p["rs"]) * (s["XS"] * (s["Zetas"] + 1.0) + s["XW"] * s["Zetaw"])
    C = lam - 1.0
    dCd = C - s["Cd"]
    eta = jnp.where(dCd < 0.0, p["etas"], p["etal"])
    Fd = eta * dCd
    F1 = jnp.exp(p["p_b"] * C) - 1.0  # plain exp lowers in every kernel route
    Tp = p["p_a"] * (F1 + Fd)
    return Ta, Tp, Ta + Tp


def rhs(states, t, parameters):
    """Full right-hand side d(states)/dt, shape (52, n)."""
    p = _unpack_params(parameters)
    gates, linear, explicit = _compute(states, t, p)
    out = []
    for i, name in enumerate(_STATE_NAMES):
        x = states[i]
        if name in gates:
            x_inf, tau = gates[name]
            out.append((x_inf - x) / tau)
        elif name in linear:
            x_inf, rate = linear[name]
            out.append((x_inf - x) * rate)
        else:
            out.append(explicit[name])
    return jnp.stack(out)


def forward_euler(states, t, parameters, dt, **kwargs):
    states = jnp.asarray(states)
    return states + dt * rhs(states, t, parameters)


def generalized_rush_larsen(states, t, parameters, dt, **kwargs):
    states = jnp.asarray(states)
    p = _unpack_params(parameters)
    gates, linear, explicit = _compute(states, t, p)
    out = []
    for i, name in enumerate(_STATE_NAMES):
        x = states[i]
        if name in gates:
            x_inf, tau = gates[name]
            out.append(x_inf + (x - x_inf) * jnp.exp(-dt / tau))
        elif name in linear:
            x_inf, rate = linear[name]
            out.append(x_inf + (x - x_inf) * jnp.exp(-dt * rate))
        else:
            out.append(x + dt * explicit[name])
    return jnp.stack(out)
