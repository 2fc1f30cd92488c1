"""Production-scale ECG recovery timing.

Builds :class:`~fenicsx_beat_tpu.ecg.ECGRecovery` on the Niederer slab at
a production resolution (default dx=0.05, 3.45M nodes / 20.6M cells),
registers a 12-lead electrode set (10 electrodes), and times the
per-frame cost of the full recovery path: warm-started mass solve for Im
(XLA stencil SpMV) plus the device-side electrode
matvec.  Only ``n_electrodes`` scalars cross the host link per frame.

The reference's equivalent re-assembles a dolfinx form over the full mesh
per electrode per frame under MPI (``ecg.py:229-298`` there).

``python -m fenicsx_beat_tpu.benchmarks.ecg_scale [dx]`` writes
``results/ecg_scale.json``.
"""

from __future__ import annotations

import json
import sys
import time as _time
from pathlib import Path

import numpy as np

# A plausible electrode layout for the 20x7x3 mm slab scaled up: limb +
# precordial positions a few slab-lengths away (any fixed layout works —
# the cost is layout-independent)
ELECTRODES_MM = {
    "RA": (-20.0, -10.0, 40.0),
    "LA": (40.0, -10.0, 40.0),
    "LL": (40.0, 30.0, -40.0),
    "RL": (-20.0, 30.0, -40.0),
    "V1": (5.0, 3.5, 25.0),
    "V2": (9.0, 3.5, 25.0),
    "V3": (13.0, 3.5, 22.0),
    "V4": (17.0, 3.5, 20.0),
    "V5": (21.0, 3.5, 18.0),
    "V6": (25.0, 3.5, 16.0),
}


def run_ecg_scale(dx: float = 0.05, n_frames: int = 10) -> dict:
    import jax.numpy as jnp

    from .. import fem
    from ..ecg import ECGRecovery, Leads12
    from ..geometry import get_3D_slab_geometry

    tic = _time.perf_counter()
    geo = get_3D_slab_geometry(None, dx=dx, Lx=20.0, Ly=7.0, Lz=3.0)
    V = fem.functionspace(geo.mesh, ("P", 1))
    v = fem.Function(V)
    # a propagating-wavefront-like voltage profile (exact shape irrelevant
    # to cost); host numpy so no device pull is ever needed
    x = V.dof_coords
    v.x.array[:] = -85.0 + 125.0 / (1.0 + np.exp(-(x[:, 0] - 6.0) / 0.5))
    mesh_s = _time.perf_counter() - tic

    tic = _time.perf_counter()
    ecg = ECGRecovery(v=v, M=1.0, operator_cache_key=f"niederer-slab-dx{dx:g}")
    setup_s = _time.perf_counter() - tic

    tic = _time.perf_counter()
    ecg.register_electrodes(list(ELECTRODES_MM.values()))
    weights_s = _time.perf_counter() - tic

    # frame loop: shift the wavefront, re-solve warm-started, read leads
    iters = []
    best_frame = float("inf")
    tic_all = _time.perf_counter()
    for k in range(n_frames):
        tic = _time.perf_counter()
        v.x.array[:] = -85.0 + 125.0 / (1.0 + np.exp(-(x[:, 0] - 6.0 - 0.2 * k) / 0.5))
        im, info = ecg.solve_device()
        phi = ecg.electrode_potentials(im)
        best_frame = min(best_frame, _time.perf_counter() - tic)
        iters.append(int(info.iterations))
    total_s = _time.perf_counter() - tic_all

    leads = Leads12(
        RA=phi[0], LA=phi[1], LL=phi[2], RL=phi[3],
        V1=phi[4], V2=phi[5], V3=phi[6], V4=phi[7], V5=phi[8], V6=phi[9],
    )
    import jax

    return {
        "backend": jax.default_backend(),
        "dx": dx,
        "n_nodes": V.ndofs,
        "n_cells": geo.mesh.num_cells,
        "n_electrodes": len(ELECTRODES_MM),
        "mesh_build_s": round(mesh_s, 1),
        "recovery_setup_s": round(setup_s, 1),
        "electrode_weights_s": round(weights_s, 1),
        "n_frames": n_frames,
        "frames_total_s": round(total_s, 2),
        "best_frame_s": round(best_frame, 3),
        "cg_iters_per_frame": iters,
        "lead_I_sample": float(np.asarray(leads.I)),
    }


def main() -> int:
    dx = float(sys.argv[1]) if len(sys.argv) > 1 else 0.05
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    out = run_ecg_scale(dx=dx, n_frames=frames)
    path = Path("results/ecg_scale.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
