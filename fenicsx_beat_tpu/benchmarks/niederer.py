"""Niederer 2011 benchmark (20x7x3 mm TP06 slab) on the fused solver.

Re-creates the reference's headline benchmark
(``demos/niederer_benchmark.py``): S1 stimulus in a 1.5 mm corner cube,
Niederer conductivities (g_il=0.17, g_it=0.019, g_el=0.62, g_et=0.24 S/m,
chi=1400/cm, C_m=1 uF/cm^2, amplitude 50,000 uA/cm^3 — reference
``demos/niederer_benchmark.py:126-162``), activation times recorded at the
8 slab corners P1-P8 and center P9.  Published activation-time table for
comparison: reference ``demos/niederer_benchmark.py:301-311``.
"""

from __future__ import annotations

import json
import time as _time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .. import fem
from ..conductivities import default_conductivities, define_conductivity_tensor
from ..fused import FusedMonodomainSolver
from ..geometry import get_3D_slab_geometry
from ..mesh import locate_entities, meshtags
from ..models import tentusscher_panfilov_2006 as tp06
from ..stimulation import define_stimulus
from ..telemetry import BaseMonitor, NullMonitor
from ..units import ureg

# Published reference activation times (ms) at (dx, dt) -> P1..P9, from the
# table committed in the reference repo (demos/niederer_benchmark.py:301-311).
PUBLISHED_ACTIVATION_TIMES = {
    (0.5, 0.05): [1.25, 51.1, 34.9, 58.9, 14.1, 49.5, 34.0, 56.65, 26.05],
    (0.5, 0.01): [1.22, 50.85, 33.96, 58.05, 13.98, 49.36, 33.07, 55.91, 25.64],
    (0.5, 0.005): [1.215, 50.775, 33.825, 57.96, 13.97, 49.345, 32.945, 55.825, 25.595],
    (0.2, 0.05): [1.25, 29.7, 32.9, 40.2, 9.55, 30.0, 32.95, 39.9, 18.9],
    (0.2, 0.01): [1.24, 29.09, 31.25, 38.66, 9.34, 29.4, 31.29, 38.42, 18.14],
    (0.2, 0.005): [1.235, 29.015, 31.05, 38.475, 9.315, 29.32, 31.08, 38.235, 18.045],
    (0.1, 0.05): [1.25, 26.85, 33.3, 40.35, 8.4, 27.5, 33.85, 40.55, 18.95],
    (0.1, 0.01): [1.23, 25.64, 31.46, 38.08, 8.03, 26.24, 31.94, 38.21, 17.95],
    (0.1, 0.005): [1.225, 25.5, 31.26, 37.81, 7.99, 26.09, 31.72, 37.93, 17.835],
}

LX, LY, LZ = 20.0, 7.0, 3.0  # mm
POINT_NAMES = ["P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8", "P9"]


def benchmark_points() -> dict[str, tuple[float, float, float]]:
    return {
        "P1": (0.0, 0.0, 0.0),
        "P2": (0.0, LY, 0.0),
        "P3": (LX, 0.0, 0.0),
        "P4": (LX, LY, 0.0),
        "P5": (0.0, 0.0, LZ),
        "P6": (0.0, LY, LZ),
        "P7": (LX, 0.0, LZ),
        "P8": (LX, LY, LZ),
        "P9": (LX / 2, LY / 2, LZ / 2),
    }


@dataclass
class NiedererResult:
    dx: float
    dt: float
    activation_times: dict[str, float]
    wall_time_s: float
    simulated_ms: float
    n_nodes: int
    n_steps: int
    cg_iters_total: int = 0
    theta: float = 1.0
    compile_s: float = 0.0

    @property
    def cg_iters_per_step(self) -> float:
        return self.cg_iters_total / self.n_steps if self.n_steps else 0.0

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_time_s if self.wall_time_s > 0 else 0.0

    def error_vs_published(self) -> float | None:
        """Max relative error vs the committed table
        (reference demos/niederer_benchmark.py:301-311).

        Godunov (theta=1) rows compare against the same-(dx, dt) published
        row — like-for-like including the splitting error.  Strang
        (theta=0.5) at coarse dt is SECOND order: its activation times sit
        near the dt->0 limit, so it is judged against the finest published
        dt row at this dx (the converged reference) — judging it by its
        distance from a first-order-contaminated coarse-dt row would score
        accuracy as error (e.g. dx=0.1 P8: Strang 38.55 vs converged
        37.93 (1.6%) vs published dt=0.05 40.55)."""
        key = (self.dx, self.dt)
        if self.theta == 0.5:
            fine = [d for (dxk, d) in PUBLISHED_ACTIVATION_TIMES if dxk == self.dx]
            if fine:
                key = (self.dx, min(fine))
        if key not in PUBLISHED_ACTIVATION_TIMES:
            return None
        ref = PUBLISHED_ACTIVATION_TIMES[key]
        errs = []
        for name, r in zip(POINT_NAMES, ref):
            mine = self.activation_times.get(name, -1.0)
            if mine < 0:
                return float("inf")
            errs.append(abs(mine - r) / r)
        return max(errs)

    def summary(self) -> str:
        at = ", ".join(f"{k}={v:.2f}" for k, v in self.activation_times.items())
        err = self.error_vs_published()
        ref_name = "published" if self.theta != 0.5 else "converged(dt->0 row)"
        err_s = f", max_rel_err_vs_{ref_name}={err:.3%}" if err is not None else ""
        return (
            f"Niederer dx={self.dx} dt={self.dt}: {at}\n"
            f"wall={self.wall_time_s:.2f}s for {self.simulated_ms:.0f}ms sim "
            f"({self.ms_per_second:.1f} ms/s, {self.n_nodes} nodes){err_s}"
        )


def niederer_problem(
    dx: float = 0.5,
    theta: float = 1.0,
    scheme: str = "generalized_rush_larsen",
    model=None,
) -> dict:
    """Keyword arguments of the Niederer configuration (slab, S1 cube, TP06
    by default) shared by the fused and the sharded solvers."""
    mesh_unit = "mm"
    geo = get_3D_slab_geometry(None, dx=dx, Lx=LX, Ly=LY, Lz=LZ)
    mesh = geo.mesh

    conductivities = default_conductivities("Niederer")
    chi = conductivities["chi"]
    C_m = (1.0 * ureg("uF/cm**2")).to(f"uF/{mesh_unit}**2").magnitude

    # S1: 1.5 mm corner cube
    L = 1.5
    tol = 1e-10
    cells = locate_entities(
        mesh,
        mesh.tdim,
        lambda x: np.logical_and(np.logical_and(x[0] <= L + tol, x[1] <= L + tol), x[2] <= L + tol),
    )
    S1_marker = 1
    S1_tags = meshtags(mesh, mesh.tdim, cells, S1_marker)
    I_s = define_stimulus(
        mesh=mesh,
        chi=chi,
        time=fem.Constant(0.0),
        subdomain_data=S1_tags,
        marker=S1_marker,
        mesh_unit=mesh_unit,
        amplitude=50_000.0,
        duration=2.0,
    )

    M = define_conductivity_tensor(f0=geo.f0, **conductivities)

    model = model or tp06
    init_states = model.init_state_values()
    # zero the model's own pacing stimulus (name differs per model family)
    for key in ("stim_amplitude", "i_Stim_Amplitude"):
        try:
            parameters = model.init_parameter_values(**{key: 0.0})
            break
        except KeyError:
            continue
    else:
        parameters = model.init_parameter_values()
    v_name = "V" if "V" in model._STATE_NAMES else "v"
    return dict(
        mesh=mesh,
        M=M,
        ode_fun=getattr(model, scheme),
        init_states=init_states,
        parameters=parameters,
        v_index=model.state_index(v_name),
        I_s=I_s,
        theta=theta,
        C_m=C_m,
    )


def _build_solver(
    dx: float = 0.5,
    theta: float = 1.0,
    scheme: str = "generalized_rush_larsen",
    model=None,
    monitor: BaseMonitor | None = None,
    dtype=None,
    probe_points: np.ndarray | None = None,
    **solver_kwargs,
) -> FusedMonodomainSolver:
    """Niederer-configuration fused solver (:func:`niederer_problem`)."""
    # benchmark configs are fixed -> safe to disk-cache the assembled
    # operators (the metric times the solve, not host setup)
    solver_kwargs.setdefault("operator_cache_key", f"niederer-slab-dx{dx:g}")
    return FusedMonodomainSolver(
        **niederer_problem(dx=dx, theta=theta, scheme=scheme, model=model),
        monitor=monitor or NullMonitor(),
        dtype=dtype,
        probe_points=probe_points,
        **solver_kwargs,
    )


def run_niederer_benchmark(
    dx: float = 0.5,
    dt: float = 0.05,
    T: float = 100.0,
    theta: float = 1.0,
    scheme: str = "generalized_rush_larsen",
    model=None,
    outdir: Path | None = None,
    monitor: BaseMonitor | None = None,
    check_interval_ms: float = 20.0,
    dtype=None,
    **solver_kwargs,
) -> NiedererResult:
    """Run the benchmark on the fused solver.

    The horizon is the FULL ``T`` (chunks dispatched asynchronously, one
    host sync at the end) and extends in whole chunks until all nine
    probe points have activated — the same outcome as the reference's
    early-stopping loop (``demos/niederer_benchmark.py:256``) without its
    per-iteration host probes.  One chunk is compiled and run first
    (``compile_s``, set-up); the timed window starts from the initial
    state and ends at the host sync."""
    import jax.numpy as jnp

    points = benchmark_points()
    pcoords = np.array(list(points.values()))
    solver = _build_solver(
        dx=dx,
        theta=theta,
        scheme=scheme,
        model=model,
        monitor=monitor,
        dtype=dtype,
        probe_points=pcoords,
        **solver_kwargs,
    )

    # One invocation per chunk with the probe readout fused into it.  (The
    # reference evaluates probes on host each loop iteration,
    # demos/niederer_benchmark.py:256-262.)
    chunk_steps = max(1, int(round(check_interval_ms / dt)))
    dtj = jnp.asarray(dt, dtype=solver.states.dtype)
    amps = solver.stimulus_amplitudes()

    # compile + first run of the one chunk shape the window uses; the
    # results are discarded (the window restarts from the initial state)
    tic = _time.perf_counter()
    warm = solver._run_chunk_probed(
        solver.states, solver.activation_time, jnp.asarray(0.0, dtype=solver.states.dtype),
        dtj, amps, chunk_steps,
    )
    warm[-1].block_until_ready()
    compile_s = _time.perf_counter() - tic

    t = 0.0
    n_steps = 0
    it_total = []
    probe_act = np.full(len(points), -1.0)
    tic = _time.perf_counter()
    # always whole chunks: a remainder chunk would compile a new static
    # n_steps inside the window.  Chunks are dispatched back to back and
    # the host syncs once per horizon, then once per extension chunk
    # until every probe has activated (capped at 10 T).
    while t < T - 1e-9 or (not (probe_act >= 0).all() and t < 10 * T):
        tj = jnp.asarray(t, dtype=solver.states.dtype)
        out = solver._run_chunk_probed(
            solver.states, solver.activation_time, tj, dtj, amps, chunk_steps
        )
        solver.states, solver.activation_time = out[0], out[1]
        it_total.append(out[4])
        t += chunk_steps * dt
        n_steps += chunk_steps
        if t >= T - 1e-9:
            probe_act = np.asarray(out[-1])
    wall = _time.perf_counter() - tic

    activation = {name: float(a) for name, a in zip(points.keys(), probe_act)}
    result = NiedererResult(
        dx=dx,
        dt=dt,
        activation_times=activation,
        wall_time_s=wall,
        simulated_ms=t,
        n_nodes=solver.V.ndofs,
        n_steps=n_steps,
        cg_iters_total=int(sum(int(i) for i in it_total)),
        theta=theta,
        compile_s=compile_s,
    )

    if outdir is not None:
        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        payload = dict(activation, dx=dx, dt=dt)
        at_file = outdir / "activation_times.json"
        existing = json.loads(at_file.read_text()) if at_file.is_file() else []
        existing.append(payload)
        at_file.write_text(json.dumps(existing, indent=2))
    return result
