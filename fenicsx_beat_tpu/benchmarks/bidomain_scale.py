"""Bidomain performance characterization on the accelerator.

The reference is monodomain-only (its JOSS paper derives monodomain from
this model, ``joss-paper/paper.md:42-51``), so there is no reference
number to beat — this artifact pins the framework's OWN bidomain claims
with measurements, the way ``bench.py`` pins the monodomain ones:

* **Niederer slab** (the reference's headline geometry,
  ``demos/niederer_benchmark.py``) at dx=0.5 / 0.2 / 0.1 with the TP06
  ionic model: wall ms-simulated/s, CG iterations/step with the DCT
  spectral u_e preconditioner, and the slowdown factor vs the monodomain
  solver on the same mesh (the bidomain solve carries two extra SpMV
  streams and the elliptic block per CG iteration).
* **Unstructured LV ellipsoid** with fiber-anisotropic Niederer
  conductivities: the SA-AMG u_e preconditioner (ops/amg.py) measured on
  the device — iterations/step vs the Jacobi fallback at the same
  tolerance, plus the AMG setup cost.

``python -m fenicsx_beat_tpu.benchmarks.bidomain_scale --out FILE``
writes the rows as JSON.  Each timed window is preceded by a warmup
window of the same chunk size (compile), and the wall clock covers
device-synchronized chunked solves only.
"""

from __future__ import annotations

import argparse
import json
import time as _time
from pathlib import Path

import numpy as np

from .. import fem
from ..bidomain import BidomainSolver
from ..conductivities import conductivity_tensor, default_conductivities
from ..fused import FusedMonodomainSolver
from ..geometry import get_3D_slab_geometry, get_lv_ellipsoid_geometry
from ..mesh import locate_entities, meshtags
from ..models import tentusscher_panfilov_2006 as tp06
from ..stimulation import define_stimulus
from ..telemetry import PerformanceMonitor
from ..units import ureg
from .niederer import LX, LY, LZ


class _IterMonitor(PerformanceMonitor):
    def __init__(self):
        super().__init__()
        self.iters: list[int] = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


def _bidomain_tensors(f0):
    """Separate intra/extra conductivity tensors (NOT the monodomain
    harmonic mean): Niederer g_il/g_it/g_el/g_et scaled by 1/chi to
    uA/mV, the same unit convention define_conductivity_tensor uses."""
    c = default_conductivities("Niederer")
    chi = c["chi"]
    scale = lambda g: (g / chi).to("uA/mV").magnitude  # noqa: E731
    M_i = conductivity_tensor(scale(c["g_il"]), scale(c["g_it"]), f0)
    M_e = conductivity_tensor(scale(c["g_el"]), scale(c["g_et"]), f0)
    return M_i, M_e


def _slab_problem(dx):
    geo = get_3D_slab_geometry(None, dx=dx, Lx=LX, Ly=LY, Lz=LZ)
    mesh = geo.mesh
    chi = default_conductivities("Niederer")["chi"]
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude
    tol = 1e-10
    cells = locate_entities(
        mesh, mesh.tdim,
        lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol),
    )
    tags = meshtags(mesh, mesh.tdim, cells, 1)
    I_s = define_stimulus(
        mesh=mesh, chi=chi, time=fem.Constant(0.0), subdomain_data=tags,
        marker=1, mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    return geo, mesh, I_s, C_m


def _lv_problem(psize_ref):
    geo = get_lv_ellipsoid_geometry(psize_ref=psize_ref)
    mesh = geo.mesh
    chi = default_conductivities("Niederer")["chi"]
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude
    apex_x = mesh.coords[:, 0].min()
    cells = locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0)
    tags = meshtags(mesh, 3, cells, 1)
    I_s = define_stimulus(
        mesh=mesh, chi=chi, time=fem.Constant(0.0), subdomain_data=tags,
        marker=1, mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    return geo, mesh, I_s, C_m


def _tp06_kwargs():
    return dict(
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        theta=1.0,
        pde_theta=0.5,
    )


def _timed_solve(solver, T_warm, T_timed, dt, chunk_steps=100):
    """Warmup window (compile), then a device-synchronized timed window;
    returns (wall_s, ms_per_s).  One fixed chunk size for warmup AND
    timing so the timed window compiles nothing: ``T_warm`` and
    ``T_timed`` must be whole multiples of ``chunk_steps * dt``."""
    for T_w in (T_warm, T_timed):
        n = T_w / (chunk_steps * dt)
        if abs(n - round(n)) > 1e-6 or round(n) < 1:
            raise ValueError(
                f"window {T_w} ms is not a whole number of {chunk_steps}-step chunks"
            )
    solver.solve((0.0, T_warm), dt=dt, save_freq=chunk_steps)
    t0 = _time.perf_counter()
    solver.solve((T_warm, T_warm + T_timed), dt=dt, save_freq=chunk_steps)
    wall = _time.perf_counter() - t0
    return wall, (T_timed / wall if wall > 0 else 0.0)


def run_slab(dx, dt=0.05, T_warm=5.0, T_timed=10.0, u_precond="auto",
             scheme="monolithic", gs_u_rtol=None, ionic_kernel=None):
    geo, mesh, I_s, C_m = _slab_problem(dx)
    mon = _IterMonitor()
    t_setup = _time.perf_counter()
    bi = BidomainSolver(
        mesh=mesh, M_i=_bidomain_tensors(geo.f0)[0],
        M_e=_bidomain_tensors(geo.f0)[1],
        I_s=I_s, C_m=C_m, monitor=mon, u_precond=u_precond,
        scheme=scheme, gs_u_rtol=gs_u_rtol, ionic_kernel=ionic_kernel,
        cache_key=f"bidomain_slab{dx:g}", **_tp06_kwargs(),
    )
    setup_s = _time.perf_counter() - t_setup
    wall, ms_per_s = _timed_solve(bi, T_warm, T_timed, dt)
    v = np.asarray(bi.v)
    row = {
        "case": f"slab_dx{dx:g}" + ("" if scheme == "monolithic" else f"_{scheme}"),
        "n_nodes": int(mesh.num_vertices),
        "dx": dx,
        "dt": dt,
        "scheme": scheme,
        "gs_u_rtol": gs_u_rtol,
        "u_precond": "dct" if bi._u_dct else ("amg" if bi._u_amg else "jacobi"),
        "ionic_route": bi.ionic_route,
        "setup_s": setup_s,
        "timed_ms": T_timed,
        "wall_s": wall,
        "ms_per_s": ms_per_s,
        "cg_iters_max": int(max(mon.iters)),
        "cg_iters_mean": float(np.mean(mon.iters)),
        "v_max": float(v.max()),
        "finite": bool(np.isfinite(v).all()),
    }

    # matched monodomain (harmonic mean) for the slowdown factor
    from ..conductivities import define_conductivity_tensor

    mon2 = _IterMonitor()
    M = define_conductivity_tensor(
        f0=geo.f0, **default_conductivities("Niederer")
    )
    mono = FusedMonodomainSolver(
        mesh=mesh, M=M, I_s=I_s, C_m=C_m, monitor=mon2,
        ionic_kernel=ionic_kernel, **_tp06_kwargs(),
    )
    wall_m, ms_per_s_m = _timed_solve(mono, T_warm, T_timed, dt)
    row["mono_ms_per_s"] = ms_per_s_m
    row["mono_cg_iters_max"] = int(max(mon2.iters)) if mon2.iters else 0
    row["bidomain_slowdown"] = ms_per_s_m / ms_per_s if ms_per_s else None
    return row


def run_lv(psize_ref, dt=0.05, T_warm=5.0, T_timed=10.0,
           preconds=("jacobi", "amg"), scheme="monolithic", gs_u_rtol=None,
           u_amg_opts=None):
    geo, mesh, I_s, C_m = _lv_problem(psize_ref)
    M_i, M_e = _bidomain_tensors(geo.f0)
    rows = []
    for precond in preconds:
        mon = _IterMonitor()
        t_setup = _time.perf_counter()
        bi = BidomainSolver(
            mesh=mesh, M_i=M_i, M_e=M_e, I_s=I_s, C_m=C_m,
            monitor=mon, u_precond=precond, scheme=scheme,
            gs_u_rtol=gs_u_rtol, u_amg_opts=u_amg_opts,
            cache_key=f"bidomain_lv{psize_ref:g}", **_tp06_kwargs(),
        )
        setup_s = _time.perf_counter() - t_setup
        wall, ms_per_s = _timed_solve(bi, T_warm, T_timed, dt)
        v = np.asarray(bi.v)
        rows.append({
            "case": f"lv_ps{psize_ref:g}_{precond}"
                    + ("" if scheme == "monolithic" else f"_{scheme}"),
            "n_nodes": int(mesh.num_vertices),
            "dt": dt,
            "scheme": scheme,
            "gs_u_rtol": gs_u_rtol,
            "u_amg_opts": {
                k: str(v) for k, v in (u_amg_opts or {}).items()
            } or None,
            "u_precond": "amg" if bi._u_amg else "jacobi",
            "setup_s": setup_s,
            "timed_ms": T_timed,
            "wall_s": wall,
            "ms_per_s": ms_per_s,
            "cg_iters_max": int(max(mon.iters)),
            "cg_iters_mean": float(np.mean(mon.iters)),
            "v_max": float(v.max()),
            "finite": bool(np.isfinite(v).all()),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dx", type=float, nargs="*", default=[0.5, 0.2, 0.1])
    ap.add_argument("--lv-psize", type=float, default=0.2)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--out", default="results/bidomain_scale.json")
    ap.add_argument("--skip-lv", action="store_true")
    ap.add_argument("--scheme", default="monolithic",
                    help="time-coupling scheme (monolithic | gs)")
    ap.add_argument("--gs-u-rtol", type=float, default=0.0,
                    help="gs elliptic-solve rtol (0 = cg_rtol)")
    ap.add_argument("--merge", action="store_true",
                    help="merge rows into an existing --out by case name "
                         "instead of overwriting the file")
    args = ap.parse_args(argv)

    from ..device import device_info, enable_compile_cache

    enable_compile_cache()

    rows = []
    for dx in args.dx:
        row = run_slab(dx, dt=args.dt, scheme=args.scheme,
                       gs_u_rtol=args.gs_u_rtol or None)
        print(json.dumps(row))
        rows.append(row)
    if not args.skip_lv:
        for row in run_lv(args.lv_psize, dt=args.dt, scheme=args.scheme,
                          gs_u_rtol=args.gs_u_rtol or None):
            print(json.dumps(row))
            rows.append(row)

    if args.merge and Path(args.out).exists():
        old = json.loads(Path(args.out).read_text())
        merged = {r["case"]: r for r in old.get("rows", [])}
        merged.update({r["case"]: r for r in rows})
        rows = list(merged.values())

    out = {
        "description": (
            "Bidomain (TP06, Godunov, pde_theta=0.5) wall performance and "
            "CG iteration counts on the real device; mono_ms_per_s is the "
            "matched monodomain solve on the same mesh"
        ),
        "device": device_info(),
        "rows": rows,
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
