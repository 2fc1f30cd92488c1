"""Cellwise ionic ODE stepping + PDE<->ODE transfer adapters.

JAX counterpart of reference ``src/beat/odesolver.py``.  The contract
is identical: a user RHS callable ``fun(states, t, parameters, dt) ->
new_states`` stepped over a ``(num_states, num_points)`` array
(``odesolver.py:67-79``), plus adapters that move the voltage row between
the raw state array and PDE-space functions (``odesolver.py:135-354``).

The callable may be plain numpy (host path — exercised by the transfer
semantics tests) or jax-traceable, in which case it is jitted and runs
vectorized on device; the fused splitting solver (``monodomain_solver``)
keeps everything on device under ``lax.scan``.
"""

from __future__ import annotations

import abc
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np

from . import fem
from .telemetry import BaseMonitor, NullMonitor

EPS = 1e-12
logger = logging.getLogger(__name__)

__all__ = [
    "ODEResults",
    "solve",
    "ODESystemSolver",
    "BaseDolfinODESolver",
    "DolfinODESolver",
    "DolfinMultiODESolver",
    "make_multi_ode",
]


class ODEResults(NamedTuple):
    y: np.ndarray
    t: np.ndarray


def solve(
    fun,
    t_bound: float,
    states,
    V,
    V_index: int,
    dt: float,
    parameters,
    t0: float = 0.0,
    extra: dict | None = None,
):
    """Step ``fun`` in place from ``t0`` until ``t_bound``, recording the
    voltage row into successive rows of ``V`` after each step (behavioral
    match of reference ``odesolver.py:24-43``; a step is taken only while
    the *next* time still lies strictly inside the horizon)."""
    kwargs = dict(extra) if extra else {}
    t, row = t0, 0
    while t + dt < t_bound:
        fun(states=states, t=t, parameters=parameters, dt=dt, **kwargs)
        V[row, :] = states[V_index, :]
        row += 1
        t += dt


class ODESystemSolver:
    """Vectorized pointwise ODE stepper over a ``[S, n]`` state array.

    Thin host-side driver around a user stepper callable with the
    gotranx calling convention ``fun(states, t, parameters, dt[,
    missing_variables]) -> new_states`` (behavioral match of reference
    ``odesolver.py:46-79``).  The callable owns the integration scheme;
    this class owns the array and writes each result back in place so
    external views of ``states`` stay valid.
    """

    def __init__(
        self,
        fun: Callable,
        states: np.ndarray,
        parameters: np.ndarray | None,
        missing_variables: np.ndarray | None = None,
        monitor: BaseMonitor | None = None,
    ):
        self.fun = fun
        self.states = states
        self.parameters = parameters
        self.missing_variables = missing_variables
        self.monitor = monitor or NullMonitor()

    @property
    def num_states(self) -> int:
        return int(self.states.shape[0])

    @property
    def num_points(self) -> int:
        return int(self.states.shape[1])

    def step(self, t0: float, dt: float) -> None:
        opt = {}
        if self.missing_variables is not None:
            opt["missing_variables"] = self.missing_variables
        with self.monitor.track_time("ode_total_step"):
            with self.monitor.track_time("ode_function_call"):
                advanced = self.fun(
                    states=self.states, t=t0, parameters=self.parameters, dt=dt, **opt
                )
            with self.monitor.track_time("ode_state_update"):
                # in-place so views handed out via .values stay live
                np.copyto(self.states, np.asarray(advanced))


class BaseDolfinODESolver(abc.ABC):
    """Transfer adapter between raw ``[S, n]`` state arrays and FE
    functions (name kept for API parity with reference
    ``odesolver.py:82-132``; the four-transfer contract —
    ``to_dolfin``/``from_dolfin`` between states and v_ode,
    ``ode_to_pde``/``pde_to_ode`` between spaces — is the spec)."""

    v_ode: fem.Function
    v_pde: fem.Function

    @property
    def _metadata(self) -> dict[str, Any] | None:
        """Assembly metadata for the ODE space (quadrature degree when the
        ODE lives at quadrature points, else None)."""
        el = self.v_ode.function_space.element
        return {"quadrature_degree": el.degree} if el.family == "Quadrature" else None

    @abc.abstractmethod
    def to_dolfin(self) -> None:
        """states[v_index] -> v_ode"""

    @abc.abstractmethod
    def from_dolfin(self) -> None:
        """v_ode -> states[v_index]"""

    def ode_to_pde(self) -> None:
        """v_ode -> v_pde (projection when the spaces differ)."""
        from .utils import local_project

        local_project(self.v_ode, self.v_pde.function_space, self.v_pde)

    def pde_to_ode(self) -> None:
        """v_pde -> v_ode (projection when the spaces differ)."""
        from .utils import local_project

        local_project(self.v_pde, self.v_ode.function_space, self.v_ode)

    @abc.abstractmethod
    def step(self, t0: float, dt: float) -> None: ...

    @property
    @abc.abstractmethod
    def full_values(self) -> np.ndarray: ...

    @abc.abstractmethod
    def assign_all_states(self, functions: list[fem.Function]) -> None: ...

    def states_to_dolfin(self, names: list[str] | None = None) -> list[fem.Function]:
        """Materialize every state row as a named FE function in the ODE
        space (for IO/postprocessing)."""
        S = self._n_state_rows()
        if names is None:
            names = [f"state_{i}" for i in range(S)]
        elif len(names) != S:
            raise ValueError(f"got {len(names)} names for {S} state rows")
        out = [fem.Function(self.v_ode.function_space, name=nm) for nm in names]
        self.assign_all_states(out)
        return out

    @abc.abstractmethod
    def _n_state_rows(self) -> int:
        """Number of state rows (uniform across markers where applicable)."""


def _tile_initial_states(init, shape: tuple[int, int]) -> np.ndarray:
    """``[S, n]`` working array from either a single ``[S]`` state vector
    (broadcast to every node) or an already-full ``[S, n]`` array."""
    init = np.asarray(init, dtype=np.float64)
    if init.shape == shape:
        return init.copy()
    return np.ascontiguousarray(np.broadcast_to(init[:, None], shape))


@dataclass
class DolfinODESolver(BaseDolfinODESolver):
    """Single-ionic-model adapter: one stepper over every node
    (behavioral match of reference ``odesolver.py:135-225``)."""

    v_ode: fem.Function
    v_pde: fem.Function
    init_states: np.ndarray
    parameters: np.ndarray | None
    fun: Callable
    num_states: int
    v_index: int = 0
    missing_variables: np.ndarray | None = None
    num_missing_variables: int = 0
    monitor: BaseMonitor = field(default_factory=NullMonitor)

    def __post_init__(self):
        self._values = _tile_initial_states(self.init_states, self.shape)
        self._ode = ODESystemSolver(
            fun=self.fun,
            states=self._values,
            parameters=self.parameters,
            missing_variables=self.missing_variables,
            monitor=self.monitor,
        )

    # -- sizes ----------------------------------------------------------
    @property
    def num_points(self) -> int:
        return self.v_ode.x.array.size

    @property
    def num_parameters(self) -> int:
        return len(self.parameters)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_states, self.num_points)

    @property
    def shape_missing_values(self) -> tuple[int, int]:
        return (self.num_missing_variables, self.num_points)

    def _n_state_rows(self) -> int:
        return self._values.shape[0]

    # -- state access ---------------------------------------------------
    @property
    def values(self) -> np.ndarray:
        return self._values

    @property
    def full_values(self) -> np.ndarray:
        return self._values

    # -- stepping & transfer --------------------------------------------
    def step(self, t0: float, dt: float):
        self._ode.step(t0=t0, dt=dt)

    def to_dolfin(self) -> None:
        self.v_ode.x.array[:] = self._values[self.v_index]

    def from_dolfin(self) -> None:
        self._values[self.v_index] = self.v_ode.x.array

    def assign_all_states(self, functions: list[fem.Function]) -> None:
        if len(functions) != self._values.shape[0]:
            raise ValueError(
                f"got {len(functions)} functions for {self._values.shape[0]} state rows"
            )
        for row, f in zip(self._values, functions):
            f.x.array[:] = row


class _MarkerBlock(NamedTuple):
    """One marker's slice of a multi-model system: the nodes it labels,
    its own ``[S_m, n_m]`` state array, and the stepper bound to it."""

    nodes: np.ndarray  # bool mask over the ODE-space dofs
    states: np.ndarray
    stepper: ODESystemSolver


@dataclass
class DolfinMultiODESolver(BaseDolfinODESolver):
    """Heterogeneous-tissue adapter: the ``markers`` function partitions
    the nodes, and each marker value runs its own ionic model / parameters
    / initial states on its partition (behavioral match of reference
    ``odesolver.py:228-354``; the fused/sharded solvers get the same
    semantics compiler-friendly via :func:`make_multi_ode`)."""

    v_ode: fem.Function
    v_pde: fem.Function
    markers: fem.Function
    init_states: dict[int, np.ndarray]
    parameters: dict[int, np.ndarray]
    fun: dict[int, Callable]
    num_states: dict[int, int]
    v_index: dict[int, int]
    monitor: BaseMonitor = field(default_factory=NullMonitor)

    def __post_init__(self):
        labels = self.markers.x.array
        if labels.size != self.v_ode.x.array.size:
            raise RuntimeError("Marker and voltage need to be in the same function space")

        self._blocks: dict[int, _MarkerBlock] = {}
        for m in self.init_states:
            nodes = labels == m
            states = _tile_initial_states(
                self.init_states[m], (self.num_states[m], int(nodes.sum()))
            )
            self._blocks[m] = _MarkerBlock(
                nodes=nodes,
                states=states,
                stepper=ODESystemSolver(
                    fun=self.fun[m],
                    states=states,
                    parameters=self.parameters[m],
                    monitor=self.monitor,
                ),
            )

        rows = set(self.num_states.values())
        self._uniform_rows = rows.pop() if len(rows) == 1 else None
        if self._uniform_rows is not None:
            self._union = np.zeros((self._uniform_rows, labels.size))

    # -- sizes ----------------------------------------------------------
    def num_points(self, marker: int) -> int:
        return self._blocks[marker].states.shape[1]

    def num_parameters(self, marker: int) -> int:
        return len(self.parameters[marker])

    def shape(self, marker: int) -> tuple[int, int]:
        return self._blocks[marker].states.shape

    def _n_state_rows(self) -> int:
        if self._uniform_rows is None:
            raise RuntimeError(
                f"state counts differ across markers ({self.num_states}); "
                "materialize per marker via .values(marker)"
            )
        return self._uniform_rows

    # -- state access ---------------------------------------------------
    def values(self, marker: int) -> np.ndarray:
        return self._blocks[marker].states

    @property
    def full_values(self) -> np.ndarray:
        if self._uniform_rows is None:
            raise RuntimeError(
                f"state counts differ across markers ({self.num_states}); "
                "no single full array exists — use .values(marker)"
            )
        for blk in self._blocks.values():
            self._union[:, blk.nodes] = blk.states
        return self._union

    # -- stepping & transfer --------------------------------------------
    def step(self, t0: float, dt: float):
        with self.monitor.track_time("total_ode_step"):
            for m, blk in self._blocks.items():
                with self.monitor.track_time(f"marker_{m}_ode_step"):
                    blk.stepper.step(t0=t0, dt=dt)

    def to_dolfin(self) -> None:
        v = self.v_ode.x.array
        for m, blk in self._blocks.items():
            v[blk.nodes] = blk.states[self.v_index[m]]

    def from_dolfin(self) -> None:
        v = self.v_ode.x.array
        for m, blk in self._blocks.items():
            blk.states[self.v_index[m]] = v[blk.nodes]

    def assign_all_states(self, functions: list[fem.Function]) -> None:
        if len(functions) != self._n_state_rows():
            raise ValueError(
                f"got {len(functions)} functions for {self._n_state_rows()} state rows"
            )
        for i, f in enumerate(functions):
            for blk in self._blocks.values():
                f.x.array[blk.nodes] = blk.states[i]


def make_multi_ode(
    markers: np.ndarray,
    fun: dict[int, Callable],
    init_states: dict[int, np.ndarray],
    parameters: dict[int, np.ndarray | None],
    v_index: dict[int, int],
    dtype=np.float64,
):
    """Compose marker-partitioned ionic models into ONE jax-traceable step
    for the fused/sharded solvers (``DolfinMultiODESolver`` semantics,
    reference ``odesolver.py:228-354``, but compiler-friendly: no
    boolean-index gather/scatter).

    Every model steps the full node axis on a union state array
    ``[S_max, n]`` and a per-marker mask selects which nodes keep its
    result — nodes outside a model's marker evolve that model's dynamics
    on their own rows but are never read, so the trajectories of the
    marked nodes are exactly the per-marker ones.  Cost: each model runs
    over all nodes (2-3 markers => 2-3x ionic FLOPs), the price of static
    shapes under jit.

    Returns ``(ode_fun, init_union [S_max, n], masks [nm, n] bool,
    v_index_common)`` where ``ode_fun(states, t, parameters, dt)`` takes
    the (possibly node-sharded) ``masks`` as its ``parameters`` argument —
    per-marker parameter vectors are baked into the closure.

    Models may disagree on their voltage row: each model's rows are stored
    with its voltage swapped to row 0 (the swap is applied around every
    model call), so ``v_index_common`` is always 0 and the solvers read a
    single voltage row regardless of per-model layouts.
    """
    marker_values = tuple(sorted(fun.keys()))
    for d, name in ((init_states, "init_states"), (parameters, "parameters"), (v_index, "v_index")):
        if set(d.keys()) != set(marker_values):
            raise ValueError(f"{name} keys {set(d.keys())} != fun keys {set(marker_values)}")

    markers = np.asarray(markers)
    n = markers.shape[0]
    masks = np.stack([markers == m for m in marker_values])
    sizes, swaps = {}, {}
    init_union = None
    for i, m in enumerate(marker_values):
        init_m = np.asarray(init_states[m], dtype=np.float64)
        S_m = init_m.shape[0]
        sizes[m] = S_m
        swap = np.arange(S_m)
        v_m = int(v_index[m])
        swap[[0, v_m]] = [v_m, 0]  # involution: storage <-> model layout
        swaps[m] = swap
        if init_union is None or S_m > init_union.shape[0]:
            grown = np.zeros((S_m, n))
            if init_union is not None:
                grown[: init_union.shape[0]] = init_union
            init_union = grown
        nodes = masks[i]
        if init_m.ndim == 1:
            init_union[:S_m, nodes] = init_m[swap][:, None]
        else:
            init_union[:S_m, nodes] = init_m[swap][:, nodes]
    S_max = init_union.shape[0]

    import jax.numpy as jnp

    funs = [fun[m] for m in marker_values]
    params = [
        None if parameters[m] is None else jnp.asarray(parameters[m], dtype=dtype)
        for m in marker_values
    ]
    model_sizes = [sizes[m] for m in marker_values]
    model_swaps = [jnp.asarray(swaps[m]) for m in marker_values]
    trivial_swap = [int(v_index[m]) == 0 for m in marker_values]

    if len(marker_values) > 4:
        logger.warning(
            "make_multi_ode with %d markers: every model steps ALL nodes "
            "(%dx the single-model ionic FLOPs).  Consider merging "
            "regions that share a model.",
            len(marker_values),
            len(marker_values),
        )

    def ode_fun(states, t, parameters, dt):
        node_masks = parameters.astype(bool)  # [nm, n_loc]
        out = states
        for i, (f, p, S_m) in enumerate(zip(funs, params, model_sizes)):
            s_model = states[:S_m]
            if not trivial_swap[i]:
                s_model = s_model[model_swaps[i]]
            y = f(states=s_model, t=t, parameters=p, dt=dt)
            if not trivial_swap[i]:
                y = y[model_swaps[i]]
            if S_m < S_max:
                y = jnp.concatenate([y, states[S_m:]], axis=0)
            out = jnp.where(node_masks[i][None, :], y, out)
        return out

    return ode_fun, init_union, masks, 0
