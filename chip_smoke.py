"""Smoke check of the system on one GPU, through the entry points users call.

    python chip_smoke.py          # phases A-C on one GPU
    python chip_smoke.py --four   # only the four-GPU sharded phase

Phase A runs the Niederer north-star benchmark (dx=0.1 mm slab, 442,401
nodes, TP06 with 19 states, dt=0.05 ms, Strang splitting, float32, to full
activation) through ``benchmarks.niederer.run_niederer_benchmark`` and checks
all nine probe activation times against the published table (within 5%).

Phase B checks the hot-path operations on the card at real widths against
plain float64 references on the host (NumPy / SciPy, or the float64 CPU
backend of JAX), each with its tolerance and the reason for it.

Phase C runs the two bidomain rows of ``bench.py`` (dx=0.2 monolithic and
dx=0.1 Gauss-Seidel) and checks that they stay finite with the DCT
preconditioner engaged.

``--four`` shards the dx=0.05 slab (3,449,001 nodes) over four GPUs with
``parallel.ShardedMonodomainSolver`` and compares its nine probe activation
times with the one-GPU fused solve of the same slab (within one dt).

Every check that fails raises; the script then exits non-zero.  It also
exits non-zero, printing no result, when JAX finds no GPU.  The last line of
standard output is one JSON object: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DT = 0.05  # ms
F32_EPS = 2.0**-23  # float32 unit roundoff is half of this


def _log(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase A: the Niederer run
def phase_a(dx: float = 0.1, T: float = 40.0) -> dict:
    from fenicsx_beat_tpu.benchmarks.niederer import (
        POINT_NAMES,
        PUBLISHED_ACTIVATION_TIMES,
        run_niederer_benchmark,
    )

    res = run_niederer_benchmark(dx=dx, dt=DT, T=T, theta=0.5)
    ref_key = (dx, min(d for (x, d) in PUBLISHED_ACTIVATION_TIMES if x == dx))
    ref = PUBLISHED_ACTIVATION_TIMES[ref_key]
    _log(
        f"[A] Niederer dx={dx} mm: {res.n_nodes} nodes, {res.n_steps} steps "
        f"(dt={DT} ms, Strang), {res.simulated_ms:g} ms simulated"
    )
    for name, r in zip(POINT_NAMES, ref):
        _log(f"[A]   {name}: {res.activation_times[name]:.3f} ms (published dt={ref_key[1]}: {r} ms)")
    err = res.error_vs_published()
    _log(f"[A] ms simulated per second: {res.ms_per_second}")
    _log(f"[A] CG iterations per step: {res.cg_iters_per_step}")
    _log(f"[A] compile + first chunk seconds: {res.compile_s}")
    _log(f"[A] worst activation error vs published: {err} (limit 0.05)")
    missing = [k for k, v in res.activation_times.items() if v < 0]
    _check(not missing, f"probes not activated: {missing}")
    _check(err is not None and err <= 0.05, f"activation error {err} > 5%")
    return {"ms_per_s": res.ms_per_second, "max_act_err": err, "n_nodes": res.n_nodes}


# ---------------------------------------------------------------------------
# Phase B: reference checks at real widths
def _row_normalized_error(y, ref):
    """max over state rows of max|y - ref| / max|ref| (per-row scale)."""
    import numpy as np

    scale = np.maximum(np.abs(ref).max(axis=1), 1e-30)
    return float((np.abs(y - ref).max(axis=1) / scale).max())


def check_ionic(n: int = 442_401) -> float:
    """One TP06 generalized Rush-Larsen step at ``n`` nodes spanning V in
    [-95, 45] mV, float32 on the device through XLA and through the Pallas
    kernel (ops/ionic_kernel.py), each vs the same step in float64 NumPy."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06

    from fenicsx_beat_tpu.ops.ionic_kernel import build_ionic_step

    vi = tp06.state_index("V")
    s0 = np.tile(tp06.init_state_values()[:, None], (1, n))
    s0[vi] = np.linspace(-95.0, 45.0, n)
    p = tp06.init_parameter_values(stim_amplitude=0.0)
    dt = 0.5 * DT  # the Strang ionic half-step
    ref = tp06.generalized_rush_larsen(s0, 0.0, p, dt, xp=np)
    s32 = jnp.asarray(s0, jnp.float32)
    xla = jax.jit(lambda s: tp06.generalized_rush_larsen(s, 0.0, jnp.asarray(p, jnp.float32), dt))
    kernel = jax.jit(build_ionic_step(tp06.generalized_rush_larsen, s0.shape[0], p, vi))
    y_xla = np.asarray(xla(s32), dtype=np.float64)
    y_kernel = np.asarray(kernel(s32, s32[vi], jnp.float32(0.0), jnp.float32(dt)), dtype=np.float64)
    tol = 1e-4
    why = (
        f"tol {tol}: f32 roundoff 6e-8 amplified by ~58 exp evaluations and "
        "cancellation in the current sums; the CPU backend gives ~6e-6"
    )
    errs = {}
    for name, y in (("XLA", y_xla), ("Pallas kernel", y_kernel)):
        errs[name] = _row_normalized_error(y, ref)
        _log(
            f"[B] TP06 ionic step ({name}), {s0.shape[0]}x{n}, f32 device vs f64 "
            f"NumPy: row-normalized max error {errs[name]} ({why})"
        )
        _check(errs[name] <= tol, f"ionic step ({name}) error {errs[name]} > {tol}")
    dev = _row_normalized_error(y_kernel, y_xla)
    _log(
        f"[B] TP06 ionic step, Pallas kernel vs XLA (both f32): row-normalized "
        f"max difference {dev} ({why})"
    )
    _check(dev <= tol, f"ionic kernel vs XLA difference {dev} > {tol}")
    return max(errs.values())


def _stencil_csr(A):
    import numpy as np
    import scipy.sparse as sp

    n = A.shape[0]
    vals = np.asarray(A.vals, dtype=np.float64)
    rows = np.repeat(np.arange(n), len(A.offsets))
    cols = (np.arange(n)[:, None] + np.asarray(A.offsets)[None, :]).ravel()
    v = vals.ravel()
    keep = (cols >= 0) & (cols < n) & (v != 0.0)
    return sp.csr_matrix((v[keep], (rows[keep], cols[keep])), shape=A.shape)


def _ell_csr(A):
    import numpy as np
    import scipy.sparse as sp

    n, w = A.cols.shape
    rows = np.repeat(np.arange(n), w)
    cols = np.asarray(A.cols).ravel()
    vals = np.asarray(A.vals, dtype=np.float64).ravel()
    if A.has_tail:
        rows = np.concatenate([rows, np.asarray(A.tail_rows)])
        cols = np.concatenate([cols, np.asarray(A.tail_cols)])
        vals = np.concatenate([vals, np.asarray(A.tail_vals, dtype=np.float64)])
    return sp.csr_matrix((vals, (rows, cols)), shape=A.shape)


def _check_spmv(label: str, A64, csr, width: int) -> float:
    """Device float32 ``A @ x`` vs SciPy float64 on the same (f32-rounded)
    values and vector, normalized by ``max(|A| |x|)``."""
    import jax
    import numpy as np

    A32 = A64.with_values(np.asarray(A64.vals).astype(np.float32))
    if getattr(A64, "has_tail", False):
        A32 = A32.with_values(A32.vals, np.asarray(A64.tail_vals).astype(np.float32))
    A32 = A32.to_device()
    x = np.random.default_rng(0).standard_normal(A64.shape[0]).astype(np.float32)
    y = np.asarray(jax.jit(lambda A, v: A @ v)(A32, x), dtype=np.float64)
    csr32 = csr.astype(np.float32).astype(np.float64)
    x64 = x.astype(np.float64)
    ref = csr32 @ x64
    bound = float((abs(csr32) @ np.abs(x64)).max())
    err = float(np.abs(y - ref).max()) / bound
    tol = width * F32_EPS
    _log(
        f"[B] {label}: n={A64.shape[0]}, nnz={csr.nnz}, width {width}: "
        f"max|y - y_ref| / max(|A||x|) = {err} (tol {tol}: {width} float32 "
        "products summed, each within 2^-24 relative)"
    )
    _check(err <= tol, f"{label} error {err} > {tol}")
    return err


def check_stencil(dx: float = 0.1) -> float:
    """Niederer slab stiffness (stencil format) at dx against SciPy."""
    import numpy as np

    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.benchmarks.niederer import niederer_problem
    from fenicsx_beat_tpu.conductivities import as_cell_tensors
    from fenicsx_beat_tpu.ops.sparse import StencilMatrix

    prob = niederer_problem(dx=dx)
    V = fem.functionspace(prob["mesh"], ("P", 1))
    _, K = fem.assemble_mass_stiffness_auto(
        V, as_cell_tensors(prob["M"], prob["mesh"]), dtype=np.float64
    )
    _check(isinstance(K, StencilMatrix), "slab stiffness is not in stencil form")
    return _check_spmv(f"stencil SpMV (slab dx={dx})", K, _stencil_csr(K), K.width)


def check_ell(psize_ref: float = 0.09) -> float:
    """LV ellipsoid stiffness (ELL + COO tail) against SciPy."""
    import numpy as np

    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.conductivities import (
        as_cell_tensors,
        default_conductivities,
        define_conductivity_tensor,
    )
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.ops.sparse import ELLMatrix

    geo = get_lv_ellipsoid_geometry(psize_ref=psize_ref)
    V = fem.functionspace(geo.mesh, ("P", 1))
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))
    _, K = fem.assemble_mass_stiffness_auto(V, as_cell_tensors(M, geo.mesh), dtype=np.float64)
    _check(isinstance(K, ELLMatrix), "LV stiffness is not in ELL form")
    csr = _ell_csr(K)
    width = int(np.diff(csr.indptr).max())
    return _check_spmv(f"ELL+tail SpMV (LV psize={psize_ref})", K, csr, width)


def check_fused_f64(dx: float = 0.5, n_steps: int = 40) -> float:
    """``n_steps`` fused Strang steps at dx in float32 on the device vs the
    same run in float64 on JAX's CPU backend."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fenicsx_beat_tpu.benchmarks.niederer import _build_solver

    T = n_steps * DT

    def run(dtype):
        solver = _build_solver(dx=dx, theta=0.5, dtype=dtype, operator_cache_key=None)
        solver.solve((0.0, T), dt=DT)
        return solver.ionic_route, np.asarray(solver.v, dtype=np.float64)

    route32, v32 = run(jnp.float32)
    # the route follows the device the state lives on: the kernel on the
    # GPU, the jnp model on the CPU
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        route64, v64 = run(jnp.float64)
    _check((route32, route64) == ("triton", "xla"), f"ionic routes {route32}, {route64}")
    err = float(np.abs(v32 - v64).max())
    tol = 0.1
    _log(
        f"[B] {n_steps} fused Strang steps, slab dx={dx} ({v64.size} nodes), f32 device "
        f"({route32} ionic route) vs f64 CPU ({route64}): max |dv| = {err} mV (tol {tol} mV: mid-upstroke nodes "
        "turn f32 roundoff and the f32 CG tolerance into a small time shift "
        "times a slope of ~10^2 mV/ms; the CPU backend in f32 gives ~0.024 mV)"
    )
    _check(bool(np.isfinite(v32).all()), "fused f32 run is not finite")
    _check(err <= tol, f"fused f32 vs f64 deviation {err} mV > {tol} mV")
    return err


def phase_b() -> None:
    check_ionic()
    check_stencil()
    check_ell()
    check_fused_f64()


# ---------------------------------------------------------------------------
# Phase C: the bidomain rows of bench.py
def phase_c() -> None:
    from fenicsx_beat_tpu.benchmarks.bidomain_scale import run_slab

    for kw in (dict(dx=0.2), dict(dx=0.1, scheme="gs", gs_u_rtol=1e-4)):
        row = run_slab(dt=DT, T_warm=5.0, T_timed=10.0, **kw)
        _log(
            f"[C] bidomain {row['case']}: {row['n_nodes']} nodes, "
            f"{row['ms_per_s']} ms simulated per second, CG iterations per step "
            f"{row['cg_iters_mean']} (mean of chunk maxima), u_e preconditioner "
            f"{row['u_precond']}, ionic route {row['ionic_route']}, finite "
            f"{row['finite']}; matched monodomain "
            f"{row['mono_ms_per_s']} ms/s"
        )
        _check(row["finite"], f"{row['case']} is not finite")
        _check(row["u_precond"] == "dct", f"{row['case']} did not engage the DCT preconditioner")
        _check(row["ionic_route"] == "triton", f"{row['case']} ionic route {row['ionic_route']}")


# ---------------------------------------------------------------------------
# --four: sharded over four devices vs the one-device fused solve
def phase_four(dx: float = 0.05, T: float = 45.0, n_devices: int = 4) -> float:
    import jax
    import numpy as np

    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.benchmarks.niederer import (
        POINT_NAMES,
        benchmark_points,
        niederer_problem,
        run_niederer_benchmark,
    )
    from fenicsx_beat_tpu.parallel import ShardedMonodomainSolver, make_device_mesh

    _check(len(jax.devices()) >= n_devices, f"--four needs {n_devices} devices")
    pts = np.array(list(benchmark_points().values()))

    single = run_niederer_benchmark(dx=dx, dt=DT, T=T, theta=0.5)
    _log(
        f"[4] one device, fused: {single.n_nodes} nodes, {single.ms_per_second} "
        f"ms simulated per second, {single.cg_iters_per_step} CG iterations per step"
    )

    prob = niederer_problem(dx=dx, theta=0.5)
    tic = time.perf_counter()
    sharded = ShardedMonodomainSolver(
        device_mesh=make_device_mesh(n_devices),
        cg_rtol=1e-6,  # the fused solver's float32 tolerances
        cg_atol=1e-7,
        operator_cache_key=f"niederer-slab-dx{dx:g}",
        **prob,
    )
    setup_s = time.perf_counter() - tic
    _check(sharded.ionic_route == "triton", f"sharded ionic route {sharded.ionic_route}")
    chunk = int(round(20.0 / DT))
    n_chunks = int(np.ceil(T / (chunk * DT)))
    # warm-up chunk compiles; the timed solve restarts from the initial state
    states0, act0 = sharded.states, sharded.activation_time
    tic = time.perf_counter()
    sharded.solve((0.0, chunk * DT), dt=DT, save_freq=chunk)
    compile_s = time.perf_counter() - tic
    sharded.states, sharded.activation_time = states0, act0
    tic = time.perf_counter()
    sharded.solve((0.0, n_chunks * chunk * DT), dt=DT, save_freq=chunk)
    wall = time.perf_counter() - tic
    V = fem.functionspace(prob["mesh"], ("P", 1))
    dofs, w = fem.point_evaluation_tables(V, pts)
    act = (sharded.activation_times()[dofs] * w).sum(axis=1)
    _log(
        f"[4] {n_devices} devices, sharded ({sharded.ionic_route} ionic route): "
        f"setup {setup_s} s, compile + first chunk "
        f"{compile_s} s, {n_chunks * chunk * DT / wall} ms simulated per second"
    )
    worst = 0.0
    for name, a in zip(POINT_NAMES, act):
        b = single.activation_times[name]
        _log(f"[4]   {name}: sharded {a:.3f} ms, one device {b:.3f} ms")
        _check(a >= 0 and b >= 0, f"{name} did not activate")
        worst = max(worst, abs(a - b))
    _log(f"[4] worst activation-time difference: {worst} ms (limit dt = {DT} ms)")
    _check(worst <= DT + 1e-6, f"sharded vs one-device activation differs by {worst} ms")
    return worst


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four", action="store_true", help="run only the four-GPU sharded phase"
    )
    args = ap.parse_args(argv)

    from fenicsx_beat_tpu.device import (
        NoGPUError,
        card_line,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    try:
        info = require_gpu()
    except NoGPUError as exc:
        print(f"chip_smoke.py: {exc}", file=sys.stderr)
        return 1
    _log(f"card: {card_line()}")
    _log(f"jax devices: {info}")

    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_a()
        phase_b()
        phase_c()
    _log(f"all phases passed in {time.perf_counter() - t0} s")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
