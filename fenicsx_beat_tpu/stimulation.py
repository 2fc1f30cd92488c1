"""Stimulus protocols: measures, unit-aware amplitudes, activation patterns.

JAX counterpart of reference ``src/beat/stimulation.py``.  Where the
reference builds symbolic UFL conditionals evaluated by FFCx-generated
kernels (``stimulation.py:270``, ``:335-351``), stimuli here are plain
jax-traceable callables ``expr(x, t) -> value`` with ``x`` shaped
``[gdim, ...]``; they are evaluated at precomputed quadrature points inside
the jitted RHS assembly (see ``fem.CellQuadData.assemble_load``).  The
balanced-tree workaround for UFL recursion limits
(``stimulation.py:356-362``) is unnecessary: the random-activation pattern
is data-driven broadcasting over point/delay arrays.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .mesh import Mesh, MeshTags
from .units import Quantity, ureg

logger = logging.getLogger(__name__)

__all__ = [
    "Measure",
    "dx",
    "ds",
    "Stimulus",
    "TimeWindow",
    "compute_effective_dim",
    "get_dZ",
    "convert_amplitude",
    "compute_stimulus_unit",
    "convert_chi",
    "define_stimulus",
    "near",
    "generate_random_activation",
]


# ---------------------------------------------------------------------------
# Measures (replaces ufl.Measure; reference get_dZ at stimulation.py:63-111)


@dataclass(frozen=True)
class Measure:
    kind: str  # "cell" | "exterior_facet"
    mesh: Mesh
    subdomain_data: MeshTags | None = None
    subdomain_id: int | None = None
    metadata: dict | None = None

    def __call__(self, subdomain_id: int) -> "Measure":
        return replace(self, subdomain_id=subdomain_id)

    def integral_type(self) -> str:
        return self.kind

    def entities(self) -> np.ndarray:
        """Entity (cell or facet) indices this measure integrates over."""
        if self.subdomain_data is not None and self.subdomain_id is not None:
            return self.subdomain_data.find(self.subdomain_id)
        if self.kind == "cell":
            return np.arange(self.mesh.num_cells)
        return self.mesh.exterior_facets()


def dx(domain: Mesh, subdomain_data: MeshTags | None = None, metadata: dict | None = None) -> Measure:
    return Measure("cell", domain, subdomain_data, None, metadata)


def ds(domain: Mesh, subdomain_data: MeshTags | None = None, metadata: dict | None = None) -> Measure:
    return Measure("exterior_facet", domain, subdomain_data, None, metadata)


# ---------------------------------------------------------------------------
# Stimulus expression objects


@dataclass
class TimeWindow:
    """``amplitude`` if start <= t <= start+duration else 0 (jax-traceable).

    Mirrors the conditional window built at reference
    ``stimulation.py:270``.  ``amplitude`` is mutable to support
    ``Stimulus.assign`` (``stimulation.py:23-24``).
    """

    amplitude: float
    start: float = 0.0
    duration: float = 2.0

    def __call__(self, x, t):
        return self.amplitude * self.indicator(x, t)

    def indicator(self, x, t):
        """0/1 window with the amplitude factored out — the solvers trace
        this and multiply by a *traced* amplitude so ``Stimulus.assign``
        takes effect without recompilation."""
        on = jnp.logical_and(t >= self.start, t <= self.start + self.duration)
        return jnp.where(on, 1.0, 0.0) * jnp.ones_like(x[0])


class Stimulus(NamedTuple):
    """(expr, measure, marker) — API-compatible with reference
    ``stimulation.py:14-24``; ``expr`` is a callable ``(x, t) -> value``
    or a scalar."""

    expr: object
    dZ: Measure
    marker: int | None = None

    @property
    def dz(self) -> Measure:
        if self.marker is None:
            return self.dZ
        return self.dZ(self.marker)

    def assign(self, amp: float) -> None:
        self.expr.amplitude = amp


def stimulus_quadratures(V, stimuli, degree: int = 4, dtype=None):
    """Quadrature triples ``(quad, expr, stim)`` for a list of
    :class:`Stimulus` — the setup block every solver (OO, fused, sharded,
    bidomain) needs before :func:`separable_stimulus_terms`: entity
    extraction, cell vs facet quadrature by the measure's integral type,
    and TimeWindow-vs-general expr dispatch.  One definition so the
    solvers cannot drift (``stim`` is the originating Stimulus for
    TimeWindow entries — its live amplitude multiplies the traced
    indicator — and ``None`` otherwise)."""
    from . import fem  # lazy: avoids a module-import cycle
    from .base_model import _as_expr

    out = []
    for s in stimuli:
        measure = s.dz
        ents = measure.entities()
        if len(ents) == 0:
            continue
        if measure.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=degree, dtype=dtype)
        else:
            quad = fem.facet_quadrature(V, ents, degree=degree, dtype=dtype)
        if isinstance(s.expr, TimeWindow):
            out.append((quad, s.expr.indicator, s))
        else:
            out.append((quad, _as_expr(s.expr), None))
    return out


def separable_stimulus_terms(stim_quads):
    """Shared precompute of separable (TimeWindow) stimulus terms.

    A TimeWindow stimulus is a purely temporal 0/1 window times a fixed
    spatial load, so its unit load vector is assembled ONCE on the host
    instead of a quadrature scatter-add every step.  Used identically by the
    fused, OO, and sharded solvers so the window semantics cannot
    diverge between them.

    ``stim_quads``: list of ``(quad, expr, stim)`` where ``stim`` is the
    originating :class:`Stimulus` for TimeWindow entries and ``None``
    otherwise.  Returns ``(terms, b_units_host)`` with ``terms`` entries
    ``(slot, quad, expr, b_idx, window)``: separable entries carry
    ``b_idx`` into ``b_units_host`` and ``window = (start, duration)``;
    general entries carry their quadrature tables and traced expression.
    """
    import numpy as np

    terms, b_units = [], []
    for i, (quad, expr, stim) in enumerate(stim_quads):
        if stim is not None:
            window = (float(stim.expr.start), float(stim.expr.duration))
            terms.append((i, None, None, len(b_units), window))
            b_units.append(np.asarray(quad.assemble_load_host()))
        else:
            terms.append((i, quad, expr, None, None))
    return terms, b_units


# ---------------------------------------------------------------------------
# Effective dimension & unit conversions (mirror stimulation.py:27-207)


def compute_effective_dim(mesh: Mesh, subdomain_data: MeshTags) -> int:
    dim = subdomain_data.dim
    if mesh.tdim == 3:
        return dim
    elif mesh.tdim == 2:
        return dim + 1
    elif mesh.tdim == 1:
        return dim + 2
    raise ValueError("Invalid mesh topology dimension")


def get_dZ(mesh: Mesh, subdomain_data: MeshTags) -> Measure:
    dim = subdomain_data.dim
    if dim == mesh.tdim - 1:
        if mesh.tdim <= 1:
            raise ValueError("Invalid mesh topology dimension")
        return Measure("exterior_facet", mesh, subdomain_data)
    elif dim == mesh.tdim:
        return Measure("cell", mesh, subdomain_data)
    raise ValueError("Invalid subdomain data dimension")


def convert_amplitude(effective_dim: int, amplitude: float | Quantity) -> Quantity:
    if isinstance(amplitude, Quantity):
        return amplitude
    if effective_dim <= 1:
        unit = ureg("uA / cm")
    elif effective_dim == 2:
        unit = ureg("uA / cm**2")
    elif effective_dim == 3:
        unit = ureg("uA / cm**3")
    else:
        raise ValueError(f"Invalid effective dimension {effective_dim}. Must be 0, 1, 2 or 3.")
    logger.debug(f"Assuming amplitude is in {unit}")
    return amplitude * unit


def compute_stimulus_unit(effective_dim: int, mesh_unit: str) -> Quantity:
    if effective_dim < 0:
        raise ValueError("Effective dimension must be non-negative")
    if effective_dim > 3:
        raise ValueError("Effective dimension must be less than or equal to 3")
    if effective_dim == 0:
        return ureg("uA")
    return ureg(f"uA/{mesh_unit}**{effective_dim - 1}")


def convert_chi(chi: float | Quantity, mesh_unit: str) -> Quantity:
    if isinstance(chi, Quantity):
        return chi
    logger.debug(f"Assuming chi is in {mesh_unit}^-1")
    return chi * ureg(f"{mesh_unit}**-1")


def define_stimulus(
    mesh: Mesh,
    chi: float | Quantity,
    time,
    subdomain_data: MeshTags,
    marker: int,
    mesh_unit: str = "cm",
    duration: float = 2.0,
    amplitude: float = 500.0,
    start: float = 0.0,
) -> Stimulus:
    """Unit-aware stimulus definition (mirrors reference
    ``stimulation.py:210-272``): amplitude is converted to the effective
    integration dimension and divided by the surface-to-volume ratio chi."""
    effective_dim = compute_effective_dim(mesh, subdomain_data)
    chi_q = convert_chi(chi, mesh_unit)
    A = convert_amplitude(effective_dim, amplitude)
    dZ = get_dZ(mesh, subdomain_data)
    unit = compute_stimulus_unit(effective_dim, mesh_unit)
    amp = (A / chi_q).to(unit.units).magnitude
    expr = TimeWindow(amplitude=amp, start=start, duration=duration)
    return Stimulus(dZ=dZ, marker=marker, expr=expr)


def near(a, b, tol: float = 1e-12):
    return jnp.logical_and(a >= b - tol, a <= b + tol)


@dataclass
class RandomActivation:
    """Callable spatio-temporal activation pattern over discrete points.

    Evaluation is a broadcast over the point/delay arrays — one fused
    elementwise expression instead of the reference's N-term UFL conditional tree
    (``stimulation.py:335-362``)."""

    points: np.ndarray  # [N, d]
    delays: np.ndarray  # [N]
    stim_start: float = 0.0
    stim_duration: float = 2.0
    amplitude: float = 1.0
    tol: float = 1e-12

    def __call__(self, x, t):
        # x: [gdim, ...] -> flatten trailing dims for broadcasting
        P = jnp.asarray(self.points)  # [N, d]
        D = jnp.asarray(self.delays)  # [N]
        xd = jnp.stack([x[i] for i in range(P.shape[1])], axis=-1)  # [..., d]
        near_all = jnp.all(
            jnp.abs(xd[..., None, :] - P) <= self.tol, axis=-1
        )  # [..., N]
        t_on = jnp.logical_and(
            t >= self.stim_start + D, t <= self.stim_start + self.stim_duration + D
        )  # [N]
        active = jnp.logical_and(near_all, t_on)
        return self.amplitude * jnp.any(active, axis=-1).astype(xd.dtype)


def generate_random_activation(
    mesh: Mesh,
    time,
    points: np.ndarray,
    delays: np.ndarray,
    stim_start: float = 0.0,
    stim_duration: float = 2.0,
    stim_amplitude: float = 1.0,
    tol: float = 1e-12,
) -> RandomActivation:
    """Random multi-point activation (Purkinje-like) pattern; mirrors
    reference ``stimulation.py:279-363`` but returns a data-driven callable."""
    assert len(points) == len(delays), "Points and delays must have the same length"
    return RandomActivation(
        points=np.asarray(points, dtype=np.float64),
        delays=np.asarray(delays, dtype=np.float64),
        stim_start=stim_start,
        stim_duration=stim_duration,
        amplitude=stim_amplitude,
        tol=tol,
    )
