"""Device policy: the compile-cache rule, refusing a host without a GPU,
the trace reduction of the layer benchmark, and the GPU-only checks of
the ionic kernel (marked ``gpu``; they skip off the card)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _run(args, cwd=REPO, **env):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=_cpu_env(**env),
        capture_output=True, text=True, timeout=300,
    )


_PROBE = (
    "import jax; from fenicsx_beat_tpu.device import enable_compile_cache; "
    "d = enable_compile_cache(); print(d); print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_defaults_to_checkout_dir():
    out = _run(["-c", _PROBE])
    assert out.returncode == 0, out.stderr
    d, cfg = out.stdout.split()
    assert d == cfg == str(REPO / ".jax_cache")


def test_compile_cache_honours_env(tmp_path):
    out = _run(["-c", _PROBE], JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cc"))
    assert out.returncode == 0, out.stderr
    d, cfg = out.stdout.split()
    assert d == cfg == str(tmp_path / "cc")


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_a_host_without_gpu(script):
    out = _run([script, "--quick"] if script == "bench.py" else [script])
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not out.stdout.strip()  # no result line


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_bench_cpu_flag_runs_on_cpu():
    out = _run(["bench.py", "--cpu", "--quick", "-T", "20"])
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["device"]["platform"] == "cpu"
    assert rec["vs_baseline"] == 1.0  # all nine probes within 5%
    assert rec["value"] > 0


def test_trace_reduction_busy_union_and_idle_share():
    from fenicsx_beat_tpu.benchmarks.layers import busy_ns, idle_share, summarize

    # overlapping, nested and disjoint intervals
    assert busy_ns([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20.0
    assert busy_ns([]) == 0.0
    s = summarize([("a", 0, 10), ("b", 5, 10), ("a", 30, 5)], names=("a",))
    assert s["busy_ns"] == 20.0 and s["window_ns"] == 35
    assert s["selected_ns"] == 15.0
    # idle share of one call: 20 ns of device work in a 40 ns call
    assert np.isclose(idle_share(s["busy_ns"], 40e-9), 0.5)
    assert s["top"][0] == ("a", 15.0)
    with pytest.raises(ValueError):
        summarize([])


@pytest.mark.gpu
def test_ionic_kernel_compiled_matches_xla(gpu):
    """The Triton-compiled ionic kernel against the XLA step (float32)."""
    import jax
    import jax.numpy as jnp

    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.ops.ionic_kernel import build_ionic_step

    n = 10_000
    vi = tp06.state_index("V")
    p = tp06.init_parameter_values(stim_amplitude=0.0)
    s = np.tile(tp06.init_state_values()[:, None], (1, n)).astype(np.float32)
    s[vi] = np.linspace(-95.0, 45.0, n)
    s = jnp.asarray(s)
    dt = jnp.float32(0.025)
    y_k = jax.jit(build_ionic_step(tp06.generalized_rush_larsen, 19, p, vi))(s, s[vi], jnp.float32(0.0), dt)
    y_x = jax.jit(lambda s: tp06.generalized_rush_larsen(s, 0.0, jnp.asarray(p, jnp.float32), dt))(s)
    y_k, y_x = np.asarray(y_k, np.float64), np.asarray(y_x, np.float64)
    scale = np.abs(y_x).max(axis=1)
    assert (np.abs(y_k - y_x).max(axis=1) / scale).max() < 1e-4


@pytest.mark.gpu
def test_fused_default_ionic_route_is_the_kernel_on_gpu(gpu):
    from fenicsx_beat_tpu.benchmarks.niederer import _build_solver

    assert _build_solver(dx=0.5).ionic_route == "triton"


@pytest.mark.gpu
def test_fused_on_the_cpu_device_of_a_gpu_host(gpu):
    """A solver whose state lives on the CPU takes the XLA route and runs,
    on a host whose default backend is the GPU."""
    import jax
    import jax.numpy as jnp

    from fenicsx_beat_tpu.benchmarks.niederer import _build_solver

    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        solver = _build_solver(dx=0.5, dtype=jnp.float64, operator_cache_key=None)
        assert solver.ionic_route == "xla"
        solver.solve((0.0, 0.5), dt=0.05)
    assert np.isfinite(np.asarray(solver.v)).all()
