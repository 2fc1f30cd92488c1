"""Measured single-host CPU baseline for the Niederer benchmark.

The reference stack (DOLFINx/PETSc + gotranx NumPy ionic step) is not
installable in this environment, so this script measures a deliberately
STRONG stand-in on the same machine class (documented in BASELINE.md):

* P1 operators assembled once to scipy CSR (same matrices the reference
  assembles via DOLFINx, ``base_model.py:123`` there);
* theta-rule step: RHS = B @ v + dt * stim (CSR matvec), then the linear
  solve with the better of (a) factorize-once SuperLU (the reference's
  "direct" profile, ``base_model.py:140-157``) and (b) Jacobi-CG at the
  same tolerances the fused solver uses;
* ionic step: the in-repo TP06 generalized Rush-Larsen jitted with
  XLA-CPU — at least as fast as the reference's vectorized NumPy/gotranx
  path, so the computed speedup is conservative.

Run standalone (forces the CPU platform in-process):

    python -m fenicsx_beat_tpu.benchmarks.cpu_baseline --dx 0.5

and commit the printed JSON into ``BASELINE_CPU.json`` for ``bench.py``
to compute its ``speedup_vs_cpu`` field against.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_cpu_baseline(dx: float, dt: float = 0.05, n_steps: int = 20, warmup: int = 3) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from .. import fem
    from ..conductivities import default_conductivities, define_conductivity_tensor, as_cell_tensors
    from ..geometry import get_3D_slab_geometry
    from ..mesh import locate_entities, meshtags
    from ..models import tentusscher_panfilov_2006 as tp06
    from ..stimulation import define_stimulus
    from ..units import ureg
    from .niederer import LX, LY, LZ

    geo = get_3D_slab_geometry(None, dx=dx, Lx=LX, Ly=LY, Lz=LZ)
    mesh = geo.mesh
    conds = default_conductivities("Niederer")
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    M = define_conductivity_tensor(f0=geo.f0, **conds)
    rows, cols, mvals, kvals, shape = fem.assemble_mass_stiffness_coo(
        V, as_cell_tensors(M, mesh)
    )
    mass = sp.csr_matrix((mvals, (rows, cols)), shape=shape)
    stiff = sp.csr_matrix((kvals, (rows, cols)), shape=shape)
    pde_theta = 0.5  # Crank-Nicolson, the reference default
    A = (C_m * mass + pde_theta * dt * stiff).tocsr()
    B = (C_m * mass - (1.0 - pde_theta) * dt * stiff).tocsr()

    # S1 stimulus load (assembled once; amplitude windowed on host)
    tol = 1e-10
    cells = locate_entities(
        mesh, 3,
        lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol),
    )
    tags = meshtags(mesh, 3, cells, 1)
    I_s = define_stimulus(
        mesh=mesh, chi=conds["chi"], time=fem.Constant(0.0), subdomain_data=tags,
        marker=1, mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    quad = fem.cell_quadrature(V, I_s.dz.entities(), degree=4)
    b_stim = np.asarray(quad.assemble_load(lambda x, t: jnp.ones_like(x[0]), 0.0))
    amp = float(I_s.expr.amplitude)

    # ionic step: XLA-CPU jit of the in-repo TP06 Rush-Larsen
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    init = tp06.init_state_values()
    v_idx = tp06.state_index("V")
    states = np.tile(np.asarray(init)[:, None], (1, n))
    params_j = jnp.asarray(params)
    ode_step = jax.jit(
        lambda s, t, dt_: tp06.generalized_rush_larsen(
            states=s, t=t, parameters=params_j, dt=dt_
        )
    )

    # linear solve candidates
    diag = A.diagonal()
    use_direct = n <= 120_000  # 3-D LU fill-in explodes beyond this
    lu = spla.factorized(A.tocsc()) if use_direct else None

    def solve_cg(b, x0):
        x, info = spla.cg(A, b, x0=x0, rtol=1e-8, atol=1e-10, M=spla.LinearOperator(
            A.shape, matvec=lambda r: r / diag))
        return x

    def one_step(states, t, solve):
        s = np.array(ode_step(jnp.asarray(states), t, dt))
        v = s[v_idx]
        b = B @ v
        if t + pde_theta * dt <= 2.0:  # stimulus window
            b = b + dt * amp * b_stim
        v_new = solve(b, v)
        s[v_idx] = v_new
        return s, t + dt

    results = {}
    candidates = [("cg", solve_cg)] + ([("direct_lu", lambda b, x0: lu(b))] if lu else [])
    for name, solve in candidates:
        st = states.copy()
        t = 0.0
        for _ in range(warmup):
            st, t = one_step(st, t, solve)
        tic = time.perf_counter()
        for _ in range(n_steps):
            st, t = one_step(st, t, solve)
        wall = time.perf_counter() - tic
        results[name] = {
            "sec_per_step": wall / n_steps,
            "ms_simulated_per_sec": (n_steps * dt) / wall,
        }
    best = max(results.values(), key=lambda r: r["ms_simulated_per_sec"])
    return {
        "dx": dx,
        "dt": dt,
        "n_nodes": n,
        "n_steps_timed": n_steps,
        "solvers": results,
        "best_ms_simulated_per_sec": round(best["ms_simulated_per_sec"], 4),
        "ionic_path": "in-repo TP06 generalized Rush-Larsen, jax.jit on XLA-CPU (>= reference NumPy/gotranx)",
        "linear_path": "scipy CSR; best of factorized SuperLU and Jacobi-CG (rtol 1e-8)",
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--dx", type=float, nargs="+", default=[0.5, 0.2, 0.1])
    parser.add_argument("--dt", type=float, default=0.05)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()

    import platform

    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    out = {
        "hardware": {"cpu": cpu, "nproc": os.cpu_count(), "platform": platform.platform()},
        "configs": [],
    }
    for dx in args.dx:
        res = run_cpu_baseline(dx, dt=args.dt, n_steps=args.steps)
        print(f"dx={dx}: {res['best_ms_simulated_per_sec']} ms-sim/s "
              f"({res['n_nodes']} nodes) {res['solvers']}", file=sys.stderr)
        out["configs"].append(res)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
