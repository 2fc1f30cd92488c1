"""Differentiable-simulation cost at production scale (one accelerator).

Times the forward pass and ``jax.value_and_grad`` of a voltage-trace
loss through the full splitting loop (implicit-diff CG, checkpointed
scan) at benchmark resolutions, f32.  The classic expectation for
reverse-mode over a checkpointed loop is a 2-4x overhead over forward;
this pins the measured factor (written to
``results/adjoint_scale.json``).

Run: ``python -m fenicsx_beat_tpu.benchmarks.adjoint_scale [dx ...]``
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np


def run_adjoint_scale(dx: float, T: float = 20.0, dt: float = 0.05) -> dict:
    import jax
    import jax.numpy as jnp

    from ..adjoint import build_diff_simulator
    from ..geometry import get_3D_slab_geometry
    from ..mesh import locate_entities, meshtags
    from ..models import fitzhughnagumo as fhn
    from ..stimulation import Stimulus, TimeWindow
    from ..stimulation import dx as dx_measure

    geo = get_3D_slab_geometry(None, dx=dx, Lx=20.0, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    cells = locate_entities(
        mesh, 3, lambda x: (x[0] <= 1.5) & (x[1] <= 1.5) & (x[2] <= 1.5)
    )
    tags = meshtags(mesh, 3, cells, 1)
    I_s = Stimulus(
        expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
        dZ=dx_measure(mesh, subdomain_data=tags),
        marker=1,
    )
    n_steps = int(round(T / dt))
    probes = np.array([[20.0, 7.0, 3.0], [10.0, 3.5, 1.5], [0.0, 0.0, 0.0]])
    sim = build_diff_simulator(
        mesh,
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        v_index=fhn.state_index("v"),
        I_s=I_s,
        probe_points=probes,
        dt=dt,
        n_steps=n_steps,
        dtype=jnp.float32,
        cg_rtol=1e-6,
        cg_atol=1e-8,
    )
    ionic = jnp.asarray(fhn.init_parameter_values(), jnp.float32)
    target = sim({"g": jnp.float32(0.0012), "ionic": ionic})
    target = jax.block_until_ready(target)

    def loss(params):
        return jnp.mean((sim({**params, "ionic": ionic}) - target) ** 2)

    fwd = jax.jit(loss)
    vg = jax.jit(jax.value_and_grad(loss))
    p = {"g": jnp.float32(0.001)}

    # AOT compile timings: lower+compile only, no execution, no transfer
    t0 = time.perf_counter()
    fwd_c = fwd.lower(p).compile()
    fwd_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    vg_c = vg.lower(p).compile()
    vg_compile = time.perf_counter() - t0
    jax.block_until_ready(fwd_c(p))
    jax.block_until_ready(vg_c(p))
    fwd, vg = fwd_c, vg_c

    def best_of(f, n=3):
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(f(p))
            best = min(best, time.perf_counter() - t0)
        return best

    fwd_s = best_of(fwd)
    vg_s = best_of(vg)
    val, grad = vg(p)
    return {
        "dx": dx,
        "n_nodes": int(np.prod([int(round(L / dx)) + 1 for L in (20.0, 7.0, 3.0)])),
        "n_steps": n_steps,
        "dt": dt,
        "forward_s": round(fwd_s, 4),
        "value_and_grad_s": round(vg_s, 4),
        "adjoint_overhead_x": round(vg_s / fwd_s, 2),
        "forward_compile_s": round(fwd_compile, 1),
        "value_and_grad_compile_s": round(vg_compile, 1),
        "grad_g": float(grad["g"]),
        "loss": float(val),
    }


def _case_name(
    truncate_every: int | None, carry_clip: float | None, cotangent_scale: float
) -> str:
    if truncate_every is None and carry_clip is None and cotangent_scale == 1.0:
        return "full_beat"
    parts = ["full_beat"]
    if truncate_every is not None:
        parts.append(f"w{truncate_every}")
    if carry_clip is not None:
        parts.append(f"clip{carry_clip:g}")
    if cotangent_scale != 1.0:
        parts.append(f"cs2p{int(round(np.log2(cotangent_scale)))}")
    return "_".join(parts)


def run_full_beat(
    dx: float = 0.1,
    T: float = 1000.0,
    dt: float = 0.05,
    segments: int = 100,
    model: str = "tp06",
    truncate_every: int | None = None,
    carry_clip: float | None = None,
    cotangent_scale: float = 1.0,
) -> dict:
    """The clinical-fit horizon: value_and_grad over ONE FULL BEAT
    (20k steps at dt=0.05) at the production dx=0.1 resolution.

    Memory AND dispatch length are both bounded: a monolithic 20k-step
    value_and_grad is one device program running for minutes, so the
    horizon runs through
    :func:`~fenicsx_beat_tpu.adjoint.host_segmented_value_and_grad`
    (host-chained segment adjoints, equality-gated vs the monolithic
    gradient in tests), with per-step ``jax.checkpoint`` bounding memory
    inside each segment."""
    import jax
    import jax.numpy as jnp

    from ..adjoint import build_diff_simulator
    from ..geometry import get_3D_slab_geometry
    from ..mesh import locate_entities, meshtags
    from ..stimulation import Stimulus, TimeWindow
    from ..stimulation import dx as dx_measure

    if model == "tp06":
        from ..models import tentusscher_panfilov_2006 as mod

        v_name, params = "V", mod.init_parameter_values(stim_amplitude=0.0)
    else:
        from ..models import fitzhughnagumo as mod

        v_name, params = "v", mod.init_parameter_values(stim_amplitude=0.0)

    geo = get_3D_slab_geometry(None, dx=dx, Lx=20.0, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    cells = locate_entities(
        mesh, 3, lambda x: (x[0] <= 1.5) & (x[1] <= 1.5) & (x[2] <= 1.5)
    )
    tags = meshtags(mesh, 3, cells, 1)
    I_s = Stimulus(
        expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
        dZ=dx_measure(mesh, subdomain_data=tags),
        marker=1,
    )
    from ..adjoint import host_segmented_value_and_grad

    n_steps = int(round(T / dt))
    if n_steps % segments:
        raise ValueError("segments must divide n_steps")
    m = n_steps // segments
    probes = np.array([[20.0, 7.0, 3.0], [10.0, 3.5, 1.5], [0.0, 0.0, 0.0]])
    sim = build_diff_simulator(
        mesh,
        ode_fun=mod.generalized_rush_larsen if model == "tp06" else mod.forward_euler,
        init_states=mod.init_state_values(),
        v_index=mod.state_index(v_name),
        I_s=I_s,
        probe_points=probes,
        dt=dt,
        n_steps=m,
        dtype=jnp.float32,
        cg_rtol=1e-6,
        # cotangent scaling needs a PURE-RELATIVE CG tolerance: an
        # absolute tolerance is not invariant under the power-of-two
        # seed scaling (adjoint.cg_implicit docstring)
        cg_atol=0.0 if cotangent_scale != 1.0 else 1e-8,
    )
    ionic = jnp.asarray(np.asarray(params), jnp.float32)
    n = mesh.num_vertices
    states0 = jnp.tile(
        jnp.asarray(np.asarray(mod.init_state_values()), jnp.float32)[:, None], (1, n)
    )

    def seg_loss(traces, aux):
        return jnp.mean(traces**2) / segments

    seg_aux = [jnp.zeros(()) for _ in range(segments)]
    # physical conductivity scale (the Niederer harmonic-mean magnitude):
    # g = 1.0 on the unit stiffness is ~3 orders too diffusive and drives
    # TP06's exponential rates into f32-gradient overflow over long
    # horizons (measured: grad 288 at 20 steps, 2e8 at 200, NaN at 400)
    p = {"g": jnp.float32(0.0012)}
    np.asarray(jnp.ones((1024,), jnp.float32))  # drain the first-pull stall

    # forward-only wall (K chained dispatches)
    fwd = jax.jit(lambda pp, s, t0: sim({**pp, "ionic": ionic},
                                        states0_in=s, t0=t0, return_final=True))
    t0c = time.perf_counter()
    s = states0
    for k in range(segments):
        _tr, s = fwd(p, s, jnp.float32(k * m * dt))
    jax.block_until_ready(s)
    fwd_s = time.perf_counter() - t0c

    t0c = time.perf_counter()
    val, grad = host_segmented_value_and_grad(
        lambda pp, **kw: sim({**pp, "ionic": ionic}, **kw),
        p, seg_loss, seg_aux, segment_ms=m * dt, states0=states0,
        truncate_every=truncate_every,
        carry_clip=carry_clip,
        cotangent_scale=cotangent_scale,
    )
    vg_s = time.perf_counter() - t0c
    return {
        "case": _case_name(truncate_every, carry_clip, cotangent_scale),
        "model": model,
        **({} if truncate_every is None else {
            "truncate_every_segments": truncate_every,
            "bptt_window_ms": truncate_every * m * dt,
        }),
        **({} if carry_clip is None else {"carry_clip": carry_clip}),
        **({} if cotangent_scale == 1.0 else {"cotangent_scale": cotangent_scale}),
        "dx": dx,
        "n_nodes": int(mesh.num_vertices),
        "n_steps": n_steps,
        "dt": dt,
        "host_segments": segments,
        "segment_steps": m,
        "forward_s": round(fwd_s, 2),
        "value_and_grad_s": round(vg_s, 2),
        "adjoint_overhead_x": round(vg_s / fwd_s, 2),
        "boundary_states_gb": round(segments * np.prod(states0.shape) * 4 / 2**30, 2),
        "loss": float(val),
        "grad_g": float(grad["g"]),
        "grad_finite": bool(np.isfinite(float(grad["g"]))),
    }


def _write(out) -> None:
    path = Path("results/adjoint_scale.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")


def main() -> int:
    import jax

    args = [a for a in sys.argv[1:]]
    full_beat = "--full-beat" in args
    args = [a for a in args if a != "--full-beat"]
    dxs = [float(a) for a in args] or [0.2, 0.1]
    out = {
        "backend": jax.default_backend(),
        "model": "FitzHugh-Nagumo",
        "configs": [],
        "note_full_beat": (
            "host-segmented value_and_grad (adjoint.host_segmented_value_and_grad):"
            " segmented runs bound each dispatch. FHN full beat: finite gradient,"
            " ~3x forward. The EXACT chained TP06 full-beat gradient is NaN"
            " (finite at 400 steps, grows with horizon - the known chaotic"
            " sensitivity of long-horizon cardiac adjoints), and the f32 VJP"
            " overflows INSIDE a 10 ms window (2/100 segments NaN at zero"
            " incoming carry) until cotangent_scale=2**-64 moves the backward"
            " pass out of overflow range (exact by VJP linearity, bitwise-gated"
            " in tests/test_adjoint.py). full_beat_wN_* rows are truncated BPTT"
            " over N-segment (10 ms) windows - the windowed clinical-fit"
            " objective; clip rows add Chebyshev carry clipping (descent-"
            "direction surrogate for longer windows)."
        ),
    }
    for dx in dxs:
        row = run_adjoint_scale(dx)
        print(row, file=sys.stderr)
        out["configs"].append(row)
    if full_beat:
        # the exact chained adjoint for both models (honest divergence
        # record for TP06), then the windowed TP06 configurations: 10/20
        # ms exact truncated BPTT under cotangent scaling, and the
        # 100 ms clipped-BPTT surrogate
        CS = 2.0**-64
        cases = (
            ("fhn", {}),
            ("tp06", {}),
            ("tp06", dict(truncate_every=1, cotangent_scale=CS)),
            ("tp06", dict(truncate_every=2, cotangent_scale=CS)),
            ("tp06", dict(truncate_every=10, carry_clip=1e6, cotangent_scale=CS)),
        )
        for model, kw in cases:
            row = run_full_beat(model=model, **kw)
            print(row, file=sys.stderr)
            out["configs"].append(row)
            _write(out)
    _write(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
