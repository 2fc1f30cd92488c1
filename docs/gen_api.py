"""Generate docs/API.md — the public API reference.

Counterpart of the reference's ``docs/api.rst`` (sphinx automodule over
``beat``, ``beat.base_model``, ``beat.monodomain_model``,
``beat.monodomain_solver``, ``beat.odesolver``, ``beat.utils`` —
``/root/reference/docs/api.rst``), extended to every public module of this
package.  No sphinx dependency: walks the import tree and renders
signatures + docstring summaries to markdown.

Run from the repo root (ci.sh step 4 keeps the committed file fresh):

    python docs/gen_api.py            # rewrites docs/API.md
    python docs/gen_api.py --check    # exit 1 if docs/API.md is stale
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "docs" / "API.md"

# Public modules, in reading order.  The first six mirror the reference's
# api.rst list; the rest are this framework's additional public surface.
MODULES = [
    "fenicsx_beat_tpu",
    "fenicsx_beat_tpu.base_model",
    "fenicsx_beat_tpu.monodomain_model",
    "fenicsx_beat_tpu.monodomain_solver",
    "fenicsx_beat_tpu.odesolver",
    "fenicsx_beat_tpu.utils",
    "fenicsx_beat_tpu.fused",
    "fenicsx_beat_tpu.bidomain",
    "fenicsx_beat_tpu.adjoint",
    "fenicsx_beat_tpu.stimulation",
    "fenicsx_beat_tpu.conductivities",
    "fenicsx_beat_tpu.geometry",
    "fenicsx_beat_tpu.single_cell",
    "fenicsx_beat_tpu.ecg",
    "fenicsx_beat_tpu.telemetry",
    "fenicsx_beat_tpu.units",
    "fenicsx_beat_tpu.io",
    "fenicsx_beat_tpu.mesh",
    "fenicsx_beat_tpu.fem",
    "fenicsx_beat_tpu.cli",
    "fenicsx_beat_tpu.models",
    "fenicsx_beat_tpu.models.fitzhughnagumo",
    "fenicsx_beat_tpu.models.tentusscher_panfilov_2006",
    "fenicsx_beat_tpu.models.torord_dyncl",
    "fenicsx_beat_tpu.models.torord_dyncl_land",
    "fenicsx_beat_tpu.ops.sparse",
    "fenicsx_beat_tpu.ops.cg",
    "fenicsx_beat_tpu.ops.spectral",
    "fenicsx_beat_tpu.parallel.partition",
    "fenicsx_beat_tpu.parallel.solver",
    "fenicsx_beat_tpu.parallel.bidomain",
    "fenicsx_beat_tpu.parallel.adjoint",
    "fenicsx_beat_tpu.parallel.distributed",
    "fenicsx_beat_tpu.odefile",
    "fenicsx_beat_tpu.cache",
    "fenicsx_beat_tpu.ops.amg",
    "fenicsx_beat_tpu.native",
]


def _public_names(mod) -> list[str]:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
        names = [
            n
            for n in names
            if getattr(getattr(mod, n), "__module__", mod.__name__) == mod.__name__
            or inspect.ismodule(getattr(mod, n)) is False
        ]
        # without __all__, keep only objects defined in this module
        names = [
            n
            for n in names
            if not inspect.ismodule(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", None) == mod.__name__
        ]
    return sorted(set(names))


def _summary(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    first = doc.strip().split("\n\n")[0].replace("\n", " ").strip()
    return first


def _signature(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # module defaults (``xp=jnp``) render by name, not by install path
    return re.sub(r"<module '([\w.]+)' from '[^']*'>", r"\1", sig)


def _render_callable(name: str, obj, depth: int) -> list[str]:
    kind = "class" if inspect.isclass(obj) else "def"
    lines = [f"{'#' * depth} `{kind} {name}{_signature(obj)}`", ""]
    s = _summary(obj)
    if s:
        lines += [s, ""]
    if inspect.isclass(obj):
        for mname, m in sorted(vars(obj).items()):
            if mname.startswith("_") and mname != "__call__":
                continue
            if inspect.isfunction(m):
                ms = _summary(m)
                lines.append(
                    f"- `.{mname}{_signature(m)}`" + (f" — {ms}" if ms else "")
                )
            elif isinstance(m, property):
                ms = _summary(m.fget) if m.fget else ""
                lines.append(f"- `.{mname}` (property)" + (f" — {ms}" if ms else ""))
        if lines[-1] != "":
            lines.append("")
    return lines


def render() -> str:
    out = [
        "# API reference",
        "",
        "Generated by `python docs/gen_api.py` — do not edit by hand.",
        "Counterpart of the reference's `docs/api.rst` (sphinx automodule),",
        "covering the same six modules plus this framework's additional",
        "public surface.",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        out += [f"## `{modname}`", ""]
        s = _summary(mod)
        if s:
            out += [s, ""]
        for name in _public_names(mod):
            obj = getattr(mod, name, None)
            if obj is None or inspect.ismodule(obj):
                continue
            if callable(obj):
                out += _render_callable(name, obj, 3)
            else:
                out.append(f"- `{name}` = `{obj!r}`" if len(repr(obj)) < 60 else f"- `{name}`")
        if out[-1] != "":
            out.append("")
    return "\n".join(out).rstrip() + "\n"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="exit 1 if API.md is stale")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    text = render()
    if args.check:
        current = OUT.read_text() if OUT.exists() else ""
        if current != text:
            print("docs/API.md is stale — run: python docs/gen_api.py", file=sys.stderr)
            return 1
        print("docs/API.md is up to date")
        return 0
    OUT.write_text(text)
    print(f"wrote {OUT} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
