"""Device and compile-cache policy of the measuring entry points.

``bench.py``, ``chip_smoke.py`` and the CLI call this module, and only
this module, to decide two things:

* where JAX keeps its persistent compilation cache
  (:func:`enable_compile_cache`): the directory ``JAX_COMPILATION_CACHE_DIR``
  names when it is set, otherwise the fixed ``<checkout>/.jax_cache``
  (listed in ``.gitignore``).  The path is part of the cache key, so it
  never depends on a pid, a time or a temp directory;
* whether a GPU is present (:func:`require_gpu`): a measurement that finds
  no GPU fails instead of falling back to the CPU.

The solvers choose their kernels from the platform of the device their
state lives on (:func:`platform_of`), not from JAX's default backend.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = [
    "DEFAULT_CACHE_DIR",
    "NoGPUError",
    "card_line",
    "device_info",
    "enable_compile_cache",
    "platform_of",
    "require_gpu",
]

DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


class NoGPUError(RuntimeError):
    """JAX's default backend is not a GPU."""


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself, so
    nothing else is set); otherwise the cache lives in the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def platform_of(x) -> str:
    """Platform (``"gpu"``, ``"cpu"``) of the devices that hold array ``x``."""
    return next(iter(x.devices())).platform


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_info` of the GPU; raises :class:`NoGPUError` when JAX's
    default backend is anything else."""
    info = device_info()
    if info["platform"] != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX's default device is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on a GPU"
        )
    return info


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()
