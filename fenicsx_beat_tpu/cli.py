"""Command-line interface.

JAX counterpart of reference ``src/beat/cli.py``: argparse with
``version`` / ``run`` / ``ecg`` / ``post`` subcommands.  Unlike the
reference (where run/ecg/post are NotImplemented stubs,
``cli.py:124-129``), ``run`` executes a monodomain slab simulation via the
fused solver, and ``version`` reports the JAX device inventory.  The CLI
keeps JAX's persistent compile cache where :mod:`.device` says.
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


def setup_logging(level: int = logging.INFO) -> None:
    """Process-index-aware log format (replaces the reference's MPI-rank
    formatter + rank-0 filter, ``cli.py:8-48``)."""

    class ProcessFilter(logging.Filter):
        def filter(self, record):
            try:
                import jax

                return jax.process_index() == 0
            except Exception:
                return True

    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    handler.addFilter(ProcessFilter())
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers = [handler]
    for noisy in ("matplotlib", "jax._src"):
        logging.getLogger(noisy).setLevel(logging.WARNING)


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="beat-tpu", description="Cardiac electrophysiology solver (JAX, NVIDIA GPU)"
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("version", help="Show version and device info")

    run = sub.add_parser("run", help="Run a monodomain simulation")
    run.add_argument("--dx", type=float, default=0.5, help="slab resolution (mm)")
    run.add_argument("--dt", type=float, default=0.05, help="time step (ms)")
    run.add_argument("-T", type=float, default=20.0, help="end time (ms)")
    run.add_argument("--model", default="tentusscher_panfilov_2006", help="ionic model")
    run.add_argument("--outdir", default="results-run", help="output directory")
    run.add_argument(
        "--mesh",
        default=None,
        help="Gmsh .msh file (ASCII v2.2/v4.1 or binary v4.1) to run on "
        "instead of the built-in Niederer slab",
    )
    run.add_argument(
        "--stim-marker",
        type=int,
        default=None,
        help="cell tag to stimulate on --mesh runs (default: smallest tag "
        "in the file; untagged meshes stimulate a corner ball)",
    )
    run.add_argument(
        "--g",
        type=float,
        default=None,
        help="isotropic conductivity [uA/mV] for --mesh runs (default: the "
        "Niederer harmonic-mean longitudinal value)",
    )
    run.add_argument("--stim-amplitude", type=float, default=50_000.0)
    run.add_argument("--save-freq", type=int, default=20, help="steps per snapshot")

    ecg = sub.add_parser("ecg", help="Compute pseudo-ECG from saved voltage snapshots")
    ecg.add_argument("checkpoint", help="checkpoint file (.npz) with voltage snapshots")
    ecg.add_argument("--electrode", nargs="+", type=float, action="append", default=None)

    post = sub.add_parser("post", help="Postprocess results (activation times)")
    post.add_argument("checkpoint", help="checkpoint file (.npz)")
    return parser


def display_version_info() -> None:
    import jax

    import fenicsx_beat_tpu

    print(f"fenicsx-beat-tpu: {fenicsx_beat_tpu.__version__}")
    print(f"jax: {jax.__version__}")
    print(f"devices: {jax.devices()}")
    print(f"default backend: {jax.default_backend()}")


def _cmd_run(args) -> int:
    import importlib
    from pathlib import Path

    model = importlib.import_module(f"fenicsx_beat_tpu.models.{args.model}")
    if args.mesh is not None:
        return _run_mesh(args, model)
    from .benchmarks.niederer import run_niederer_benchmark

    res = run_niederer_benchmark(
        dx=args.dx, dt=args.dt, T=args.T, model=model, outdir=Path(args.outdir)
    )
    print(res.summary())
    return 0


def _run_mesh(args, model) -> int:
    """Monodomain run on a user-supplied Gmsh mesh (closes the gap the
    reference leaves open — its ``run`` is a NotImplemented stub,
    ``cli.py:124-129`` there): stimulate a tagged region (or a corner
    ball), march with the fused solver, write voltage snapshots the
    ``ecg``/``post`` subcommands consume."""
    from pathlib import Path

    import numpy as np

    from . import fem
    from . import io as io_mod
    from .conductivities import default_conductivities, get_harmonic_mean_conductivity
    from .fused import FusedMonodomainSolver
    from .mesh import locate_entities, meshtags
    from .stimulation import define_stimulus

    mesh, cell_tags, _facet_tags = io_mod.read_msh(args.mesh)
    logger.info(
        "Loaded %s: %d cells, %d vertices (tdim=%d)",
        args.mesh, mesh.num_cells, mesh.num_vertices, mesh.tdim,
    )
    cond = default_conductivities("Niederer")
    chi = cond["chi"]
    if cell_tags is not None:
        marker = (
            args.stim_marker
            if args.stim_marker is not None
            else int(np.min(cell_tags.values))
        )
        if marker not in cell_tags.values:
            raise SystemExit(
                f"--stim-marker {marker} not among the mesh's cell tags "
                f"{sorted(set(int(v) for v in cell_tags.values))}"
            )
        tags = cell_tags
    else:
        # untagged mesh: stimulate a ball at the bounding-box corner,
        # 10% of the domain diagonal in radius
        lo = mesh.coords.min(axis=0)
        hi = mesh.coords.max(axis=0)
        r = 0.1 * float(np.linalg.norm(hi - lo))
        cells = locate_entities(
            mesh,
            mesh.tdim,
            lambda x: sum((x[i] - lo[i]) ** 2 for i in range(mesh.gdim)) <= r * r,
        )
        marker = 1
        tags = meshtags(mesh, mesh.tdim, cells, marker)
    I_s = define_stimulus(
        mesh=mesh,
        chi=chi,
        time=fem.Constant(0.0),
        subdomain_data=tags,
        marker=marker,
        mesh_unit="mm",
        amplitude=args.stim_amplitude,
        duration=2.0,
    )
    g = args.g if args.g is not None else get_harmonic_mean_conductivity(chi).s_l
    for key in ("stim_amplitude", "i_Stim_Amplitude"):
        try:
            parameters = model.init_parameter_values(**{key: 0.0})
            break
        except KeyError:
            continue
    else:
        parameters = model.init_parameter_values()
    v_name = "V" if "V" in model._STATE_NAMES else "v"
    solver = FusedMonodomainSolver(
        mesh=mesh,
        M=float(g),
        ode_fun=model.generalized_rush_larsen,
        init_states=model.init_state_values(),
        parameters=parameters,
        v_index=model.state_index(v_name),
        I_s=I_s,
    )
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    with io_mod.CheckpointWriter(outdir / "voltage", mesh) as writer:
        n = solver.V.ndofs
        solver.solve(
            (0.0, args.T),
            dt=args.dt,
            save_freq=args.save_freq,
            save_callback=lambda t, v: writer.write(t, v[:n]),
        )
    act = solver.activation_times()[: mesh.num_vertices]
    n_act = int((act >= 0).sum())
    print(f"nodes activated: {n_act}/{act.size}")
    if n_act:
        print(f"activation time range: [{act[act >= 0].min():.2f}, {act.max():.2f}] ms")
    print(f"snapshots: {outdir / 'voltage.npz'}")
    return 0


def _cmd_ecg(args) -> int:
    import numpy as np

    from . import fem
    from . import io as io_mod
    from .ecg import ECGRecovery
    from .mesh import CellType, Mesh

    data = io_mod.load_checkpoint(args.checkpoint)
    print(f"Loaded checkpoint with {len(data.times)} snapshots, {data.values.shape[1]} dofs")
    mesh = Mesh(
        coords=np.asarray(data.coords, dtype=np.float64),
        cells=np.asarray(data.cells, dtype=np.int32),
        cell_type=CellType[str(data.cell_type)],
    )
    if args.electrode:
        electrodes = [tuple(p) for p in args.electrode]
    else:
        # default: one electrode one domain-length beyond the max corner
        lo, hi = mesh.coords.min(axis=0), mesh.coords.max(axis=0)
        electrodes = [tuple(hi + (hi - lo))]
    V = fem.functionspace(mesh, ("P", 1))
    v = fem.Function(V)
    ecg = ECGRecovery(v=v)
    forms = [ecg.eval(p) for p in electrodes]
    traces = np.zeros((len(data.times), len(electrodes)))
    for i in range(len(data.times)):
        v.x.array[:] = data.values[i]
        ecg.solve()
        for j, form in enumerate(forms):
            traces[i, j] = float(fem.assemble_scalar(form))
    out = str(args.checkpoint).replace(".npz", "") + "_ecg.npz"
    np.savez(out, times=data.times, traces=traces, electrodes=np.asarray(electrodes))
    for j, p in enumerate(electrodes):
        print(f"electrode {p}: phi_e range [{traces[:, j].min():.4e}, {traces[:, j].max():.4e}]")
    print(f"Saved traces to {out}")
    return 0


def _cmd_post(args) -> int:
    import numpy as np

    from . import io as io_mod

    data = io_mod.load_checkpoint(args.checkpoint)
    v = data.values
    act = np.full(v.shape[1], -1.0)
    for i, t in enumerate(data.times):
        newly = (v[i] > 0.0) & (act < 0)
        act[newly] = t
    print(f"activated nodes: {(act >= 0).sum()}/{act.size}")
    if (act >= 0).any():
        print(f"activation time range: [{act[act >= 0].min():.2f}, {act.max():.2f}] ms")
    return 0


def dispatch(args: argparse.Namespace) -> int:
    setup_logging(logging.DEBUG if args.verbose else logging.INFO)
    if args.command == "version":
        display_version_info()
        return 0
    if args.command == "run":
        return _cmd_run(args)
    if args.command == "ecg":
        return _cmd_ecg(args)
    if args.command == "post":
        return _cmd_post(args)
    setup_parser().print_help()
    return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    from .device import enable_compile_cache

    parser = setup_parser()
    args = parser.parse_args(argv)
    enable_compile_cache()
    return dispatch(args)


if __name__ == "__main__":
    raise SystemExit(main())
