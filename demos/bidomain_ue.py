"""Bidomain simulation: transmembrane wave + extracellular potential map.

Beyond the reference's scope (fenicsx-beat is monodomain-only): the
:class:`fenicsx_beat_tpu.bidomain.BidomainSolver` solves the coupled
(v, u_e) block system with unequal anisotropy ratios — the regime where
no monodomain reduction exists — and writes both fields for ParaView.

Run: ``python demos/bidomain_ue.py [--quick]``
"""

from __future__ import annotations

import argparse
import os as _os
import sys as _sys
from pathlib import Path

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-T", type=float, default=40.0)
    parser.add_argument("--dt", type=float, default=0.1)
    parser.add_argument("-o", "--outdir", type=Path, default=Path("results-bidomain"))
    parser.add_argument("--quick", action="store_true", help="CI smoke: coarse/short")
    args = parser.parse_args(argv)
    if args.quick:
        args.T = 5.0

    import jax

    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)

    from fenicsx_beat_tpu import mesh as meshmod
    from fenicsx_beat_tpu import stimulation
    from fenicsx_beat_tpu.bidomain import BidomainSolver
    from fenicsx_beat_tpu.io import VTUWriter
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn

    nx = 16 if args.quick else 48
    mesh = meshmod.create_unit_square(None, nx, nx)
    cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.25) & (x[1] < 0.25))
    tags = meshmod.meshtags(mesh, 2, cells, 1)
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=120.0, start=0.0, duration=2.0),
        dZ=stimulation.dx(mesh, subdomain_data=tags),
        marker=1,
    )
    # unequal anisotropy ratios: intracellular strongly fiber-biased (x),
    # extracellular nearly isotropic — the bidomain-only regime
    M_i = np.diag([0.004, 0.0004])
    M_e = np.diag([0.002, 0.0035])
    solver = BidomainSolver(
        mesh=mesh,
        M_i=M_i,
        M_e=M_e,
        ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(),
        parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"),
        I_s=I_s,
        theta=0.5,
    )
    args.outdir.mkdir(parents=True, exist_ok=True)
    writer = VTUWriter(args.outdir / "fields", mesh)
    rows = []

    def cb(t, v, u):
        writer.write(t, {"v": v, "u_e": u})
        rows.append((t, v.max(), float(np.abs(u).max())))
        print(f"t={t:6.1f}  v_max={v.max():8.2f}  |u_e|_max={np.abs(u).max():7.3f}")

    status = solver.solve((0.0, args.T), dt=args.dt, save_freq=max(1, int(2.0 / args.dt)), save_callback=cb)
    writer.close()
    print(f"status: {status}; wrote {args.outdir}/fields (v and u_e point fields)")
    from fenicsx_beat_tpu.base_model import Status

    assert status == Status.OK, f"solver did not converge: {status}"
    assert max(r[2] for r in rows) > 0.1, "no extracellular signal developed"
    return solver


if __name__ == "__main__":
    main()
