"""Benchmark: the Niederer slab on the fused solver, plus two bidomain rows.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform", "kind", "count"}, ...extras}

Primary metric: simulated milliseconds per wall-clock second on the
north-star Niederer configuration (dx=0.1 mm, 442,401 nodes, dt=0.05 ms,
TP06, Strang splitting theta=0.5, to full activation — BASELINE.md).
Extras report the Godunov dx=0.1, dx=0.5 and merged-Strang rows, CG
iterations per step, compile seconds, the measured-CPU speedup (vs the
committed ``BASELINE_CPU.json``, see
``fenicsx_beat_tpu/benchmarks/cpu_baseline.py``) and the two bidomain
slab rows (dx=0.2 monolithic, dx=0.1 Gauss-Seidel).

``vs_baseline`` reports activation-time fidelity: 1.0 means all nine
probe points match the reference's committed table
(``demos/niederer_benchmark.py:301-311``) within 5% at every benched
configuration; scaled down by the worst excess error otherwise.

The benchmark measures the GPU: it exits non-zero when JAX finds none,
unless ``--cpu`` asks for a CPU run (float64; its numbers are CPU numbers).

    python bench.py            # every row, on the GPU
    python bench.py --quick    # dx=0.5 only
    python bench.py --cpu --quick
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _fidelity(err):
    if err is None or err == float("inf"):
        return 0.0
    return round(min(1.0, 0.05 / max(err, 0.05)), 4)


def _load_cpu_baseline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_CPU.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {(c["dx"], c["dt"]): c["best_ms_simulated_per_sec"] for c in data.get("configs", [])}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dx", type=float, default=None, help="bench ONLY this dx")
    parser.add_argument("--dt", type=float, default=0.05)
    parser.add_argument("-T", type=float, default=100.0)
    parser.add_argument("--theta", type=float, default=1.0, help="splitting theta (0.5 = Strang)")
    parser.add_argument("--quick", action="store_true", help="short dx=0.5 run for smoke testing")
    parser.add_argument(
        "--cpu", action="store_true", help="run on the CPU in float64 instead of the GPU"
    )
    args = parser.parse_args(argv)

    import jax

    from fenicsx_beat_tpu.device import NoGPUError, enable_compile_cache, require_gpu

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()
    if not args.cpu:
        try:
            require_gpu()
        except NoGPUError as exc:
            print(f"bench.py: {exc} (pass --cpu for a CPU run)", file=sys.stderr)
            return 1

    from fenicsx_beat_tpu.benchmarks.niederer import run_niederer_benchmark
    from fenicsx_beat_tpu.device import device_info

    cpu_base = _load_cpu_baseline()

    if args.quick:
        configs = [(0.5, args.dt, 20.0, args.theta)]
    elif args.dx is not None:
        configs = [(args.dx, args.dt, args.T, args.theta)]
    else:
        # The PRIMARY row is the production recommendation (Strang, the
        # reference's exact choreography) at the dx=0.1 north-star
        # resolution; Godunov dx=0.5 / dx=0.1 and merged Strang (midpoint
        # activation sampling, docs/DESIGN.md §8) follow.  Horizons end at
        # full activation (P8 ~39.3 / ~56.1 ms) so the timed window is all
        # active propagation.
        configs = [
            (0.1, args.dt, min(args.T, 40.0), 0.5),
            (0.5, args.dt, min(args.T, 60.0), 1.0),
            (0.1, args.dt, min(args.T, 40.0), 1.0),
            (0.1, args.dt, min(args.T, 40.0), 0.5, True),
        ]

    extras = {}
    results = []
    for dx, dt, T, theta, *rest in configs:
        merged = bool(rest and rest[0])
        res = run_niederer_benchmark(
            dx=dx, dt=dt, T=T, theta=theta, merge_strang_halves=merged
        )
        print(f"[theta={theta:g}{' merged' if merged else ''}] {res.summary()}", file=sys.stderr)
        results.append(res)
        key = f"dx{dx:g}" + ("_strang" if theta == 0.5 else "") + ("_merged" if merged else "")
        extras[f"{key}_ms_per_s"] = res.ms_per_second
        extras[f"{key}_cg_iters_per_step"] = res.cg_iters_per_step
        extras[f"{key}_compile_s"] = res.compile_s
        err = res.error_vs_published()
        if err is not None and err != float("inf"):
            extras[f"{key}_max_act_err"] = err
        if (dx, dt) in cpu_base:
            extras[f"{key}_speedup_vs_cpu"] = res.ms_per_second / cpu_base[(dx, dt)]

    if not args.quick and args.dx is None:
        # bidomain rows (beyond the reference's scope): the dx=0.2
        # monolithic slab and the dx=0.1 Gauss-Seidel scheme, each with the
        # DCT u_e preconditioner and the matched monodomain solve
        from fenicsx_beat_tpu.benchmarks.bidomain_scale import run_slab

        for name, kw in (
            ("bidomain_dx0.2", dict(dx=0.2)),
            ("bidomain_dx0.1_gs", dict(dx=0.1, scheme="gs", gs_u_rtol=1e-4)),
        ):
            row = run_slab(dt=args.dt, T_warm=5.0, T_timed=10.0, **kw)
            extras[f"{name}_ms_per_s"] = row["ms_per_s"]
            extras[f"{name}_slowdown_vs_mono"] = row["bidomain_slowdown"]
            extras[f"{name}_cg_iters_mean"] = row["cg_iters_mean"]
            extras[f"{name}_finite"] = row["finite"]
            print(f"[{name}] {row['ms_per_s']} ms/s, {row['bidomain_slowdown']}x mono, "
                  f"precond {row['u_precond']}", file=sys.stderr)

    primary = results[0]
    vs_baseline = min(_fidelity(r.error_vs_published()) for r in results)
    out = {
        "metric": "niederer_ms_simulated_per_sec",
        "value": primary.ms_per_second,
        "unit": "ms/s",
        "vs_baseline": vs_baseline,
        "config": f"dx={primary.dx} dt={primary.dt} theta={configs[0][3]}",
        "device": device_info(),
    }
    out.update(extras)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
