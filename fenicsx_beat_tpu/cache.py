"""Disk cache for expensive host-side setup products.

The reference stack amortizes setup through long-lived library caches
(FFCx JIT kernels, PETSc/hypre reuse within a process); here the
analogous costs are one-shot host computations: smoothed-aggregation
hierarchy builds and unstructured mesh generation.  This module gives
them all one npz-backed,
content-addressed, atomically-published cache (the pattern
``fem._operator_cache_*`` established for assembled operators).

Every entry is keyed by a sha256 fingerprint over (schema, a caller
string, every option value, and the BYTES of every keyed array), so a
stale file is never served for different inputs or after a semantics
bump.  Stores are best-effort: any failure (read-only FS, disk full,
concurrent writer) degrades to a rebuild, never an error.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

# bump on any change to what cached products mean or contain
SCHEMA = 1


def cache_dir(kind: str) -> Path:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return Path(base) / "fenicsx_beat_tpu" / kind


def fingerprint(kind: str, parts, arrays=()) -> Path:
    """Cache slot for ``kind`` keyed by scalar ``parts`` (stringified)
    and the raw bytes of ``arrays``."""
    h = hashlib.sha256()
    h.update((f"{SCHEMA}|{kind}|" + "|".join(str(p) for p in parts)).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a)
    return cache_dir(kind) / f"{h.hexdigest()[:20]}.npz"


def load_arrays(path: Path) -> dict | None:
    """Load an npz slot into a plain dict of numpy arrays (None on miss
    or any corruption)."""
    if not path.is_file():
        return None
    try:
        with np.load(path, allow_pickle=False) as f:
            return {k: f[k] for k in f.files}
    except Exception:
        return None


def store_arrays(path: Path, arrays: dict) -> None:
    """Atomically publish a dict of numpy arrays to the slot: write a
    private temp file, then rename — a kill mid-savez or a concurrent
    writer never leaves a torn file at the final path."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.tmp-{os.getpid()}.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except Exception:
        pass
