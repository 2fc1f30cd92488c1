"""Minimal end-to-end demo: monodomain + modified FitzHugh-Nagumo.

JAX translation of the reference's README getting-started example
(reference README.md "Getting started"): a unit-square monodomain
simulation with a corner stimulus driving a propagating wave.
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import fenicsx_beat_tpu as beat
from fenicsx_beat_tpu import fem
from fenicsx_beat_tpu import mesh as meshmod
from fenicsx_beat_tpu.models import fitzhughnagumo as fhn


def main(T: float = 50.0, dt: float = 0.05, N: int = 32, verbose: bool = True):
    mesh = meshmod.create_unit_square(None, N, N)
    time = fem.Constant(0.0)

    ode_space = fem.functionspace(mesh, ("P", 1))

    parameters = fhn.init_parameter_values(stim_amplitude=0.0)
    init_states = fhn.init_state_values()
    v_index = fhn.state_index("v")

    # Stimulus over the lower-left quadrant for 0.5 ms
    stim_marker = 1
    cells = meshmod.locate_entities(
        mesh, mesh.tdim, lambda x: np.logical_and(x[0] <= 0.5, x[1] <= 0.5)
    )
    stim_tags = meshmod.meshtags(mesh, mesh.tdim, cells, np.full(len(cells), stim_marker))
    dx = beat.stimulation.dx(mesh, subdomain_data=stim_tags)
    stim_expr = beat.stimulation.TimeWindow(amplitude=600.0, start=0.0, duration=0.5)
    I_s = beat.Stimulus(expr=stim_expr, dZ=dx, marker=stim_marker)

    pde = beat.MonodomainModel(time=time, mesh=mesh, M=0.001, I_s=I_s, dx=dx)
    ode = beat.odesolver.DolfinODESolver(
        v_ode=fem.Function(ode_space),
        v_pde=pde.state,
        fun=fhn.forward_euler,
        init_states=init_states,
        parameters=parameters,
        num_states=len(init_states),
        v_index=v_index,
    )
    solver = beat.MonodomainSplittingSolver(pde=pde, ode=ode)

    t = 0.0
    i = 0
    probes = np.array([[0.1, 0.1], [0.9, 0.9]])
    while t < T:
        solver.step((t, t + dt))
        t += dt
        i += 1
        if verbose and i % 100 == 0:
            vals = fem.evaluate_function(pde.state, probes)
            v = pde.state.x.array
            print(
                f"t={t:7.2f}  v_range=[{v.min():8.2f}, {v.max():8.2f}]  "
                f"near_stim={vals[0]:8.2f}  far={vals[1]:8.2f}"
            )
    return pde.state


if __name__ == "__main__":
    if "--quick" in _sys.argv:  # CI smoke (ci.sh): tiny mesh, short horizon
        main(T=3.0, N=12)
    else:
        main()
