"""Multi-device weak-scaling characterization on a virtual device mesh.

The communication *structure* of the sharded solver is fully determined at
compile time, so this benchmark pins it on an N-virtual-device CPU mesh
(``--xla_force_host_platform_device_count``), the same environment the
test suite's sharding tests run under (the analogue of the reference's
whole-suite ``mpirun`` CI, ``.github/workflows/main-mpi.yml:15-31``):

* **weak scaling**: per-device node count held fixed while the slab grows
  with the device count (1/2/4/8);
* **collective census**: ``collective-permute`` (halo exchange) and
  ``all-reduce`` (CG dot products) op counts in the compiled HLO per
  chunk — the exact wire structure XLA runs between devices;
* **halo-traffic fraction**: analytic bytes crossing device boundaries
  per step (2 ppermutes of H rows per SpMV, one SpMV per CG iteration
  plus the RHS/initial-residual passes, measured average CG iterations)
  against the local HBM bytes each device streams per step;
* optionally (``--dx005``) the production dx=0.05 slab (3.45M nodes)
  sharded 8 ways: setup through the direct stencil path plus one real
  chunk — the smoke the driver's ``dryrun_multichip`` runs at toy size.

Wall-clock steps/s per device count IS reported but the virtual devices
share one physical core, so only the collective census and byte fractions
are hardware-meaningful; scaling efficiency must come from real devices.

``python -m fenicsx_beat_tpu.benchmarks.multichip`` writes
``MULTICHIP_SCALING.json`` (cited from docs/DESIGN.md §6).
"""

from __future__ import annotations

import json
import os
import sys
import time as _time
from pathlib import Path

import numpy as np


def _require_virtual_mesh(n: int) -> None:
    """Force the N-virtual-device CPU backend (pinned through jax.config
    as well as the env var, before any jax use)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def _slab_setup(dx: float, Lx: float):
    from .. import fem
    from ..conductivities import default_conductivities, define_conductivity_tensor
    from ..geometry import get_3D_slab_geometry
    from ..mesh import locate_entities, meshtags
    from ..models import tentusscher_panfilov_2006 as tp06
    from ..stimulation import define_stimulus
    from ..units import ureg

    geo = get_3D_slab_geometry(None, dx=dx, Lx=Lx, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    cond = default_conductivities("Niederer")
    tol = 1e-10
    cells = locate_entities(
        mesh,
        mesh.tdim,
        lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol),
    )
    I_s = define_stimulus(
        mesh=mesh,
        chi=cond["chi"],
        time=fem.Constant(0.0),
        subdomain_data=meshtags(mesh, mesh.tdim, cells, 1),
        marker=1,
        mesh_unit="mm",
        amplitude=50_000.0,
        duration=2.0,
    )
    return dict(
        mesh=mesh,
        M=define_conductivity_tensor(f0=geo.f0, **cond),
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=1.0,
        C_m=(1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude,
    )


def _hlo_collective_census(solver, n_steps: int) -> dict:
    """Op counts in the compiled chunk HLO — the wire structure per chunk."""
    import jax.numpy as jnp

    dtype = solver.states.dtype
    amps = solver.stimulus_amplitudes()
    lowered = solver._run_chunk_ops.lower(
        solver._operands,
        solver.states,
        solver.activation_time,
        jnp.asarray(0.0, dtype=dtype),
        jnp.asarray(0.05, dtype=dtype),
        amps,
        n_steps=n_steps,
    )
    text = lowered.compile().as_text()

    def count_op(op: str) -> int:
        # accelerators emit async pairs (<op>-start/-done); CPU the plain op.
        # Count instruction definitions: "= <type> <op>(" or "<op>-start(".
        n = 0
        for line in text.splitlines():
            if f" {op}(" in line and "=" in line:
                n += 1
            elif f" {op}-start(" in line and "=" in line:
                n += 1
        return n

    return {
        "collective_permute": count_op("collective-permute"),
        "all_reduce": count_op("all-reduce"),
    }


def run_multichip_scaling(
    device_counts=(1, 2, 4, 8),
    dx: float = 0.5,
    n_steps: int = 100,
    dt: float = 0.05,
    base_Lx: float = 10.0,
    include_dx005: bool = False,
    include_lv: bool = False,
    include_dx01: bool = False,
) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as DeviceMesh

    from ..parallel.solver import ShardedMonodomainSolver

    devs = jax.devices()
    S = None
    rows = []
    for nd in device_counts:
        if nd > len(devs):
            rows.append({"devices": nd, "skipped": f"only {len(devs)} devices"})
            continue
        # weak scaling: slab length grows with the device count, so the
        # per-device owned block is ~constant
        setup = _slab_setup(dx=dx, Lx=base_Lx * nd)
        dmesh = DeviceMesh(np.array(devs[:nd]), ("x",))
        solver = ShardedMonodomainSolver(device_mesh=dmesh, **setup)
        part = solver.part
        S = int(solver.states.shape[0])
        itemsize = jnp.dtype(solver.states.dtype).itemsize
        amps = solver.stimulus_amplitudes()
        dtj = jnp.asarray(dt, dtype=solver.states.dtype)

        census = _hlo_collective_census(solver, n_steps)

        # timed chunk (one dispatch, one sync; best of 3)
        t0 = jnp.asarray(0.0, dtype=solver.states.dtype)
        out = solver._run_chunk(
            solver.states, solver.activation_time, t0, dtj, amps, n_steps
        )
        it_max = int(out[3])  # chunk-max CG iterations of any step
        best = float("inf")
        for _ in range(3):
            tic = _time.perf_counter()
            out = solver._run_chunk(
                solver.states, solver.activation_time, t0, dtj, amps, n_steps
            )
            np.asarray(out[3])
            best = min(best, _time.perf_counter() - tic)

        # analytic per-step traffic on one device boundary (upper bound:
        # chunk-max CG iterations):  SpMV halo: 2 ppermutes x H rows;
        # SpMVs/step = CG iters (apply_A) + 1 (RHS apply_B) + 1 (initial
        # residual)
        spmvs_per_step = it_max + 2.0
        halo_bytes = 2 * part.halo * itemsize * spmvs_per_step
        K = len(solver._offsets) if solver._offsets is not None else (
            solver._vals_mass.shape[-1]
        )
        local_bytes = (
            2 * S * part.n_local * itemsize  # ionic state read+write
            + spmvs_per_step * (K + 2) * part.n_local * itemsize  # operator streams
        )
        rows.append(
            {
                "devices": nd,
                "n_nodes": solver.V.ndofs,
                "n_local": part.n_local,
                "halo_rows": part.halo,
                "max_cg_iters_per_step": it_max,
                "hlo_per_chunk": census,
                "halo_bytes_per_step_per_device": int(halo_bytes),
                "local_hbm_bytes_per_step_per_device": int(local_bytes),
                "halo_traffic_fraction": round(halo_bytes / local_bytes, 5),
                "steps_per_s_virtual": round(n_steps / best, 1),
            }
        )

    out = {
        "backend": jax.default_backend(),
        "dx": dx,
        "dt": dt,
        "n_steps_per_chunk": n_steps,
        "num_states": S,
        "note": (
            "virtual CPU mesh: collective census and byte fractions are "
            "hardware-meaningful; steps_per_s shares one physical core"
        ),
        "weak_scaling": rows,
    }

    if include_dx005 and len(devs) >= 8:
        setup = _slab_setup(dx=0.05, Lx=20.0)
        setup["operator_cache_key"] = "niederer-slab-dx0.05"
        dmesh = DeviceMesh(np.array(devs[:8]), ("x",))
        tic = _time.perf_counter()
        solver = ShardedMonodomainSolver(device_mesh=dmesh, **setup)
        setup_s = _time.perf_counter() - tic
        amps = solver.stimulus_amplitudes()
        dtj = jnp.asarray(dt, dtype=solver.states.dtype)
        t0 = jnp.asarray(0.0, dtype=solver.states.dtype)
        tic = _time.perf_counter()
        chunk = solver._run_chunk(
            solver.states, solver.activation_time, t0, dtj, amps, 2
        )
        np.asarray(chunk[3])
        out["dx005_sharded_8way"] = {
            "n_nodes": solver.V.ndofs,
            "n_local": solver.part.n_local,
            "halo_rows": solver.part.halo,
            "setup_s": round(setup_s, 1),
            "two_steps_s": round(_time.perf_counter() - tic, 1),
            "ok": True,
        }

    if include_dx01 and len(devs) >= 8:
        # the production dx=0.1 regime (442k nodes, the resolution the
        # driver bench runs): full collective census + halo fractions at
        # the scale a pod would actually shard — the weak-scaling rows
        # above measure dx=0.5 (2.2k nodes/device), where the 0.5% halo
        # fraction says little about this regime
        setup = _slab_setup(dx=0.1, Lx=20.0)
        setup["operator_cache_key"] = "niederer-slab-dx0.1"
        dmesh = DeviceMesh(np.array(devs[:8]), ("x",))
        tic = _time.perf_counter()
        solver = ShardedMonodomainSolver(device_mesh=dmesh, **setup)
        setup_s = _time.perf_counter() - tic
        part = solver.part
        S01 = int(solver.states.shape[0])
        itemsize = jnp.dtype(solver.states.dtype).itemsize
        amps = solver.stimulus_amplitudes()
        dtj = jnp.asarray(dt, dtype=solver.states.dtype)
        t0 = jnp.asarray(0.0, dtype=solver.states.dtype)
        census = _hlo_collective_census(solver, 10)
        tic = _time.perf_counter()
        chunk = solver._run_chunk(
            solver.states, solver.activation_time, t0, dtj, amps, 10
        )
        it_max = int(chunk[3])
        run_s = _time.perf_counter() - tic
        spmvs_per_step = it_max + 2.0
        halo_bytes = 2 * part.halo * itemsize * spmvs_per_step
        K = len(solver._offsets) if solver._offsets is not None else (
            solver._vals_mass.shape[-1]
        )
        local_bytes = (
            2 * S01 * part.n_local * itemsize
            + spmvs_per_step * (K + 2) * part.n_local * itemsize
        )
        out["dx01_sharded_8way"] = {
            "n_nodes": solver.V.ndofs,
            "n_local": part.n_local,
            "halo_rows": part.halo,
            "max_cg_iters_per_step": it_max,
            "hlo_per_chunk_10_steps": census,
            "halo_bytes_per_step_per_device": int(halo_bytes),
            "local_hbm_bytes_per_step_per_device": int(local_bytes),
            "halo_traffic_fraction": round(halo_bytes / local_bytes, 6),
            "setup_s": round(setup_s, 1),
            "ten_steps_s": round(run_s, 1),
            "ok": True,
        }

    if include_lv and len(devs) >= 8:
        # production UNSTRUCTURED capability: the 1.87M-node / 10.6M-cell
        # LV ellipsoid sharded 8 ways through RCM + direct ELL assembly +
        # hybrid apex tail (the structured dx=0.05 row above exercises the
        # stencil partition; this exercises the general-mesh path at the
        # same scale)
        from ..geometry import get_lv_ellipsoid_geometry
        from ..mesh import meshtags
        from ..models import tentusscher_panfilov_2006 as tp06
        from ..stimulation import Stimulus, TimeWindow, dx as dx_measure

        tic = _time.perf_counter()
        geo = get_lv_ellipsoid_geometry(psize_ref=0.05)
        mesh_s = _time.perf_counter() - tic
        m = geo.mesh
        tags = meshtags(m, m.tdim, np.arange(5000), 1)
        I_s = Stimulus(
            expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
            dZ=dx_measure(m, subdomain_data=tags),
            marker=1,
        )
        dmesh = DeviceMesh(np.array(devs[:8]), ("x",))
        tic = _time.perf_counter()
        solver = ShardedMonodomainSolver(
            mesh=m,
            M=0.001,
            ode_fun=tp06.generalized_rush_larsen,
            init_states=tp06.init_state_values(),
            parameters=tp06.init_parameter_values(stim_amplitude=0.0),
            v_index=tp06.state_index("V"),
            I_s=I_s,
            device_mesh=dmesh,
        )
        setup_s = _time.perf_counter() - tic
        amps = solver.stimulus_amplitudes()
        dtj = jnp.asarray(dt, dtype=solver.states.dtype)
        t0 = jnp.asarray(0.0, dtype=solver.states.dtype)
        tic = _time.perf_counter()
        chunk = solver._run_chunk(
            solver.states, solver.activation_time, t0, dtj, amps, 2
        )
        np.asarray(chunk[3])
        out["lv_10p6M_cells_sharded_8way"] = {
            "n_nodes": solver.V.ndofs,
            "n_cells": m.num_cells,
            "n_local": solver.part.n_local,
            "halo_rows": solver.part.halo,
            "ell_width": int(solver._cols.shape[-1]) if solver._cols is not None else None,
            "apex_tail": solver._tail is not None,
            "mesh_build_s": round(mesh_s, 1),
            "setup_s": round(setup_s, 1),
            "two_steps_s": round(_time.perf_counter() - tic, 1),
            "ok": True,
        }

    return out


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dx", type=float, default=0.5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dx005", action="store_true", help="also shard the 3.45M-node mesh 8 ways")
    ap.add_argument("--lv", action="store_true", help="also shard the 10.6M-cell LV ellipsoid 8 ways")
    ap.add_argument("--dx01", action="store_true",
                    help="also census the production dx=0.1 slab (442k nodes) 8 ways")
    args = ap.parse_args()
    _require_virtual_mesh(8)
    out = run_multichip_scaling(
        dx=args.dx, n_steps=args.steps, include_dx005=args.dx005,
        include_lv=args.lv, include_dx01=args.dx01,
    )
    Path("MULTICHIP_SCALING.json").write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
