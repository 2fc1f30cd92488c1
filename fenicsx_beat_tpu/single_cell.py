"""0-D single-cell pacing to steady state (limit cycle), with hash cache.

JAX counterpart of reference ``src/beat/single_cell.py``: run
``nbeats`` beats of ``BCL`` ms with timestep ``dt`` and cache the final
state to ``.npy`` keyed by an md5 of the RHS bytecode + arguments
(``single_cell.py:68-110``).  Where the reference JITs the sequential
Python loop with Numba, the loop here is a ``jax.lax.scan`` compiled by
XLA — the states for all tracked beats stream out of the scan without
host round-trips.  Non-traceable (pure numpy) RHS callables fall back to
a host loop.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path
from typing import Callable

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "compute_hash",
    "solve_with_save",
    "solve_without_save",
    "get_steady_state",
]


def compute_hash(
    fun: Callable,
    init_states: np.ndarray,
    parameters: np.ndarray,
    nbeats: int = 200,
    BCL: float = 1000.0,
    dt: float = 0.05,
) -> str:
    """Cache key: md5 over RHS bytecode and run arguments
    (mirrors reference ``single_cell.py:68-83``)."""
    hash_input = hashlib.md5()
    code = getattr(fun, "__code__", None)
    if code is not None:
        hash_input.update(code.co_code)
    else:
        hash_input.update(repr(fun).encode())
    hash_input.update(str(init_states).encode())
    hash_input.update(str(parameters).encode())
    hash_input.update(str(nbeats).encode())
    hash_input.update(str(BCL).encode())
    hash_input.update(str(dt).encode())
    return hash_input.hexdigest()


def _try_scan_solver(fun, y0, p, times, nbeats, dt, track_indices=None, save_freq=1):
    """Compile the pacing loop as nested lax.scans; returns None if the RHS
    is not jax-traceable."""
    try:
        import jax
        import jax.numpy as jnp

        y0j = jnp.asarray(y0)
        pj = None if p is None else jnp.asarray(p)
        tj = jnp.asarray(times)

        def step(y, t):
            y_new = fun(states=y, t=t, parameters=pj, dt=dt)
            return y_new, None

        if track_indices is None:

            def beat(y, _):
                y_end, _ = jax.lax.scan(step, y, tj)
                return y_end, None

            @jax.jit
            def run(y):
                y_final, _ = jax.lax.scan(beat, y, None, length=nbeats)
                return y_final

            out = run(y0j)
            return np.asarray(out), None

        idx = jnp.asarray(np.asarray(track_indices, dtype=np.int32))
        n_save = int(np.ceil(len(times) / save_freq))

        def step_save(y, t_and_save):
            t, do_save = t_and_save
            tracked = jnp.where(do_save, y[idx], jnp.nan)
            y_new = fun(states=y, t=t, parameters=pj, dt=dt)
            return y_new, tracked

        save_mask = (np.arange(len(times)) % save_freq) == 0

        def beat(y, _):
            y_end, tracked = jax.lax.scan(step_save, y, (tj, jnp.asarray(save_mask)))
            return y_end, tracked

        @jax.jit
        def run(y):
            y_final, tracked = jax.lax.scan(beat, y, None, length=nbeats)
            return y_final, tracked

        y_final, tracked = run(y0j)
        tracked = np.asarray(tracked).reshape(-1, len(track_indices))
        tracked = tracked[~np.isnan(tracked[:, 0])]
        return np.asarray(y_final), tracked
    except Exception as e:  # non-traceable RHS -> host loop
        logger.debug("lax.scan pacing failed (%s); falling back to host loop", e)
        return None


def solve_without_save(fun, nbeats, times, y, p, dt):
    """Host-loop fallback mirroring reference ``single_cell.py:60-65``."""
    for _ in range(nbeats):
        for t in times:
            y[:] = np.asarray(fun(states=y, t=t, parameters=p, dt=dt))
    return y


def solve_with_save(fun, nbeats, times, y, p, dt, save_freq, track_values, track_indices):
    """Host-loop fallback mirroring reference ``single_cell.py:42-57``."""
    k = 0
    for _ in range(nbeats):
        for j, t in enumerate(times):
            if j % save_freq == 0:
                for i, index in enumerate(track_indices):
                    track_values[k, i] = y[index]
                k += 1
            y[:] = np.asarray(fun(states=y, t=t, parameters=p, dt=dt))
    return y, track_values


def get_steady_state(
    fun: Callable,
    init_states: np.ndarray,
    parameters: np.ndarray,
    outdir: Path,
    nbeats: int = 200,
    BCL: int = 1000,
    save_every_ms: float = 1.0,
    dt: float = 0.05,
    track_indices: list[int] | None = None,
) -> np.ndarray:
    """Pace a single cell to steady state; mirrors reference
    ``single_cell.py:86-156`` (cache hit at ``:107-110``)."""
    outdir = Path(outdir)
    hash_input = compute_hash(
        fun=fun,
        init_states=init_states,
        parameters=parameters,
        nbeats=nbeats,
        BCL=BCL,
        dt=dt,
    )
    fname = outdir / f"steady_states_{hash_input}.npy"
    if fname.is_file():
        return np.load(fname)
    outdir.mkdir(exist_ok=True, parents=True)

    logger.info(f"Computing steady state with {nbeats} beats.")
    times = np.arange(0.0, BCL, dt)

    if track_indices is not None:
        save_freq = int(np.ceil(save_every_ms / dt))
        result = _try_scan_solver(
            fun, init_states, parameters, times, nbeats, dt, track_indices, save_freq
        )
        if result is not None:
            y, track_values = result
        else:
            M = int(np.ceil(len(times) / save_freq) * nbeats)
            track_values = np.zeros((M, len(track_indices)))
            y, track_values = solve_with_save(
                fun,
                nbeats,
                times,
                np.array(init_states, dtype=np.float64),
                parameters,
                dt,
                save_freq,
                track_values,
                np.asarray(track_indices, dtype=np.int32),
            )
        np.save(outdir / f"tracked_values_{hash_input}.npy", track_values)
        _plot_tracked(outdir, hash_input, track_values, times, save_freq, BCL, nbeats, save_every_ms)
    else:
        result = _try_scan_solver(fun, init_states, parameters, times, nbeats, dt)
        if result is not None:
            y, _ = result
        else:
            y = solve_without_save(
                fun, nbeats, times, np.array(init_states, dtype=np.float64), parameters, dt
            )

    np.save(fname, y)
    return y


def _plot_tracked(outdir, hash_input, track_values, times, save_freq, BCL, nbeats, save_every_ms):
    """Diagnostic plots of tracked states (reference ``single_cell.py:142-151``)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("Matplotlib not installed, plotting not available.")
        return
    M, N = track_values.shape
    fig, ax = plt.subplots(N, 2, sharex="col", sharey="row", squeeze=False)
    last = int(np.ceil(BCL / save_every_ms))
    for i in range(N):
        ax[i, 0].plot(np.linspace(0, BCL * nbeats, M), track_values[:, i])
        ax[i, 1].plot(times[::save_freq][-last:], track_values[-last:, i])
    fig.tight_layout()
    fig.savefig(outdir / f"tracked_values_{hash_input}.png")
    plt.close(fig)
