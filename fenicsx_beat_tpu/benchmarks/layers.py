"""Per-layer times of the monodomain hot path on the GPU, from profiler traces.

    python -m fenicsx_beat_tpu.benchmarks.layers [--out results/layers.json]

Measures at the Niederer north-star width (442,401 nodes) and on the
329,712-node LV ellipsoid:

* the TP06 ionic step through XLA and through the Pallas kernel
  (:mod:`..ops.ionic_kernel`), against the floor of reading and writing the
  19 state rows once;
* the stencil SpMV (slab) and the ELL + tail SpMV (LV) against their byte
  floors;
* one Jacobi-PCG iteration on the dx=0.1 theta system: host wall time and
  device busy time per iteration, and the device idle share of one solve;
* one 400-step Strang chunk of the Niederer run for each ionic route: device
  busy time per step, idle share, and the ionic share of busy time;
* the whole Niederer run (``run_niederer_benchmark``) for each ionic route,
  in turns (xla, triton, triton, xla): ms simulated per second end to end.

Device times are sums of kernel durations in a ``jax.profiler`` trace
(:func:`device_events`); wall times are host clocks around work that ends in
``block_until_ready``, taken without the profiler.  The idle share of a call
is ``1 - busy / wall`` of that one call (:func:`idle_share`): a trace window
spanning several calls would count the host gaps between them, and the
profiler slows the traced call down.  The host time of the traced call is
recorded beside it, as the profiler's cost.  Every record names the device
it ran on.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # NVIDIA H100 SXM data sheet


# ---------------------------------------------------------------------------
# trace reduction
def busy_ns(intervals) -> float:
    """Length of the union of ``(start, duration)`` intervals."""
    total = 0.0
    end = -np.inf
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def device_events(logdir: str) -> list[tuple[str, float, float]]:
    """``(name, start_ns, duration_ns)`` of every kernel and copy the GPU
    ran, from the newest trace under ``logdir``."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True), key=os.path.getmtime)
    out = []
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                out.extend((e.name, e.start_ns, e.duration_ns) for e in line.events)
    return out


def summarize(events, names=None) -> dict:
    """Busy time, trace window and per-name sums of ``events``."""
    if not events:
        raise ValueError("the trace holds no device events")
    lo = min(s for _, s, _ in events)
    hi = max(s + d for _, s, d in events)
    busy = busy_ns([(s, d) for _, s, d in events])
    per_name: dict[str, float] = {}
    for name, _, d in events:
        per_name[name] = per_name.get(name, 0.0) + d
    out = {"busy_ns": busy, "window_ns": hi - lo}
    if names is not None:
        out["selected_ns"] = sum(v for k, v in per_name.items() if any(n in k for n in names))
    out["top"] = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    return out


def idle_share(busy: float, wall_s: float) -> float:
    """Share of ``wall_s`` host seconds in which the device ran nothing,
    given ``busy`` ns of device work in the same call."""
    return 1.0 - busy / 1e9 / wall_s


def traced(fn, *args, reps: int = 10, host_s: list | None = None):
    """Run ``fn(*args)`` ``reps`` times under the profiler (after one
    untraced warm call); returns the device events.  ``host_s`` collects
    the host seconds of the traced calls."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(reps):
            tic = time.perf_counter()
            jax.block_until_ready(fn(*args))
            if host_s is not None:
                host_s.append(time.perf_counter() - tic)
        jax.profiler.stop_trace()
        return device_events(d)


def wall(fn, *args, reps: int = 20) -> float:
    """Median host seconds of ``fn(*args)`` to ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        tic = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - tic)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
def ionic(n: int, peak: float) -> dict:
    import jax
    import jax.numpy as jnp

    from ..models import tentusscher_panfilov_2006 as tp06
    from ..ops.ionic_kernel import build_ionic_step

    vi = tp06.state_index("V")
    p = tp06.init_parameter_values(stim_amplitude=0.0)
    s0 = np.tile(tp06.init_state_values()[:, None], (1, n)).astype(np.float32)
    v = np.linspace(-95.0, 45.0, n).astype(np.float32)
    s0j, vj = jnp.asarray(s0), jnp.asarray(v)
    t, dt = jnp.float32(0.0), jnp.float32(0.025)
    pj = jnp.asarray(p, jnp.float32)

    xla = jax.jit(lambda s, v, t, dt: tp06.generalized_rush_larsen(s.at[vi].set(v), t, pj, dt))
    ref = np.asarray(xla(s0j, vj, t, dt), dtype=np.float64)
    floor_s = 2 * s0.nbytes / peak
    reps = 10
    rows = {"floor_us": floor_s * 1e6}
    ev = traced(xla, s0j, vj, t, dt, reps=reps)
    rows["xla"] = {
        "device_us": sum(d for _, _, d in ev) / reps / 1e3,
        "wall_us": wall(xla, s0j, vj, t, dt) * 1e6,
        "kernels_per_call": len(ev) / reps,
    }
    for block, warps in ((32, 1), (64, 1), (64, 2), (128, 2), (128, 4), (256, 8)):
        k = jax.jit(build_ionic_step(tp06.generalized_rush_larsen, 19, p, vi, block=block, num_warps=warps))
        y = np.asarray(k(s0j, vj, t, dt), dtype=np.float64)
        dev = np.abs(y - ref).max(axis=1) / np.maximum(np.abs(ref).max(axis=1), 1e-30)
        ev = traced(k, s0j, vj, t, dt, reps=reps)
        rows[f"triton_b{block}_w{warps}"] = {
            "device_us": sum(d for _, _, d in ev) / reps / 1e3,
            "wall_us": wall(k, s0j, vj, t, dt) * 1e6,
            "kernels_per_call": len(ev) / reps,
            "max_row_normalized_dev_vs_xla": float(dev.max()),
        }
    return rows


def spmv(label: str, A, bytes_per_call: float, peak: float) -> dict:
    import jax

    A = A.to_device()
    x = jax.device_put(np.random.default_rng(0).standard_normal(A.shape[0]).astype(np.float32))
    f = jax.jit(lambda A, x: A @ x)
    reps = 20
    ev = traced(f, A, x, reps=reps)
    dev = sum(d for _, _, d in ev) / reps / 1e3
    return {
        "case": label,
        "n": A.shape[0],
        "device_us": dev,
        "wall_us": wall(f, A, x) * 1e6,
        "floor_us": bytes_per_call / peak * 1e6,
        "kernels_per_call": len(ev) / reps,
    }


def cg_iteration(solver) -> dict:
    """Per-iteration cost of the fused solver's Jacobi-PCG on its dx theta
    system, from two fixed-iteration-count solves (rtol 0)."""
    import jax
    import jax.numpy as jnp

    from ..ops.cg import cg

    op = solver._operands
    dt = 0.05
    A = op["mass"].combine(solver.C_m, op["stiff"], 0.5 * dt)
    b = jax.device_put(np.random.default_rng(1).standard_normal(solver._n).astype(np.float32))
    diag = A.diagonal()

    def solve(A, b, diag, k):
        return cg(lambda u: A @ u, b, jnp.zeros_like(b), precond_diag=diag, rtol=0.0, atol=0.0, maxiter=k)[0]

    f = {k: jax.jit(lambda A, b, d, k=k: solve(A, b, d, k)) for k in (20, 120)}
    w = {k: wall(f[k], A, b, diag, reps=10) for k in f}
    host = {k: [] for k in f}
    ev = {k: traced(f[k], A, b, diag, reps=1, host_s=host[k]) for k in f}
    busy = {k: summarize(ev[k])["busy_ns"] for k in f}
    return {
        # marginal costs: the 100 iterations between the two solves
        "wall_us_per_iteration": (w[120] - w[20]) / 100 * 1e6,
        "device_busy_us_per_iteration": (busy[120] - busy[20]) / 100 / 1e3,
        "idle_share": idle_share(busy[120], w[120]),
        "wall_ms_per_solve": w[120] * 1e3,
        "traced_host_ms_per_solve": host[120][0] * 1e3,
        "device_to_host_copies_per_iteration": sum(1 for e in ev[120] if "MemcpyD2H" in e[0]) / 120,
    }


def niederer_chunk(route: str):
    """(record, solver) for one traced 400-step Strang chunk at dx=0.1."""
    import jax
    import jax.numpy as jnp

    from .niederer import _build_solver, benchmark_points

    solver = _build_solver(
        dx=0.1, theta=0.5, probe_points=np.array(list(benchmark_points().values())),
        ionic_kernel=route,
    )
    amps = solver.stimulus_amplitudes()
    dt = jnp.float32(0.05)
    out = solver._run_chunk(solver.states, solver.activation_time, jnp.float32(0.0), dt, amps, 400)
    jax.block_until_ready(out)
    st, act = out[0], out[1]
    run = lambda: solver._run_chunk(st, act, jnp.float32(20.0), dt, amps, 400)  # noqa: E731
    w = wall(run, reps=3)
    host: list = []
    ev = traced(run, reps=1, host_s=host)
    iters = int(run()[4])
    names = ("ionic_step",) if solver.ionic_route != "xla" else ("concatenate", "exponential")
    s = summarize(ev, names=names)
    return {
        "route": solver.ionic_route,
        "wall_ms_per_step": w / 400 * 1e3,
        "traced_host_ms_per_step": host[0] / 400 * 1e3,
        "device_busy_ms_per_step": s["busy_ns"] / 400 / 1e6,
        "idle_share": idle_share(s["busy_ns"], w),
        "cg_iterations_per_step": iters / 400,
        "top_kernels_ms": [(k, v / 1e6) for k, v in s["top"]],
    }, solver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/layers.json")
    args = ap.parse_args(argv)

    from .. import fem
    from ..conductivities import as_cell_tensors, default_conductivities, define_conductivity_tensor
    from ..device import card_line, device_info, enable_compile_cache, require_gpu
    from ..geometry import get_lv_ellipsoid_geometry
    from .niederer import run_niederer_benchmark

    enable_compile_cache()
    info = require_gpu()
    peak = HBM_BYTES_PER_S[info["kind"]]
    rec = {"device": info, "card": card_line(), "hbm_peak_bytes_per_s": peak}
    rec["ionic"] = ionic(442_401, peak)
    print(json.dumps(rec["ionic"]), flush=True)

    chunks = {}
    # route None is the default: the kernel on the GPU
    for route in ("xla", None, None, "xla"):
        r, solver = niederer_chunk(route)
        chunks.setdefault(r["route"], []).append(r)
        print(json.dumps(r), flush=True)
    rec["niederer_chunk"] = chunks
    runs = []
    for route in ("xla", None, None, "xla"):
        res = run_niederer_benchmark(dx=0.1, dt=0.05, T=40.0, theta=0.5, ionic_kernel=route)
        runs.append({
            "route": route or "default",
            "ms_per_s": res.ms_per_second,
            "max_act_err": res.error_vs_published(),
            "cg_iters_per_step": res.cg_iters_per_step,
        })
        print(json.dumps(runs[-1]), flush=True)
    rec["niederer_runs"] = runs
    rec["cg"] = cg_iteration(solver)
    print(json.dumps(rec["cg"]), flush=True)

    n = solver._n
    K = solver._stiff.width
    rec["stencil"] = spmv("slab dx=0.1 stiffness", solver._stiff, (K + 2) * 4 * n, peak)
    del solver
    geo = get_lv_ellipsoid_geometry(psize_ref=0.09)
    V = fem.functionspace(geo.mesh, ("P", 1))
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))
    _, Kl = fem.assemble_mass_stiffness_auto(V, as_cell_tensors(M, geo.mesh), dtype=np.float32)
    nl, W = Kl.cols.shape
    nt = Kl.tail_rows.shape[0] if Kl.has_tail else 0
    # vals + cols per stored entry, x read once, y written once, tail COO
    rec["ell"] = spmv("LV psize=0.09 stiffness", Kl, (8 * W + 8) * nl + 12 * nt, peak)
    rec["ell"].update(width=W, tail_entries=nt)
    print(json.dumps({"stencil": rec["stencil"], "ell": rec["ell"]}), flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
