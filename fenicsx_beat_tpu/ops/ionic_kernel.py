"""Single-kernel ionic step for the GPU (Pallas, Triton route).

XLA lowers the TP06 generalized Rush-Larsen step into two loop fusions
that pass nine intermediate rows between them through device memory.  This
kernel runs the whole step as one program per block of nodes: the program
loads its block of every state row (the voltage row from the live voltage
vector, so the solver needs no row update before the step), evaluates the
model traced in with its parameters baked in as constants, and stores every
row once — the floor of ``2 * S * itemsize`` bytes per node.

The model is traced over a list of row blocks through the ``xp`` argument
of the model convention (:mod:`..models.tentusscher_panfilov_2006`):
``xp.asarray`` keeps the list, ``xp.stack`` returns it, and every other name
is ``jax.numpy``.  A model qualifies when it takes ``xp`` and indexes its
states by row only; :func:`supports` tells.

The route is Triton (``backend="triton"``); ``interpret=True`` runs the same
kernel through the Pallas interpreter (tests on the CPU).

:func:`make_ionic_step` is the one place the solvers (fused, bidomain,
sharded) choose between this kernel and the jnp model through XLA: the
kernel when the model qualifies and the solver's state lives on a GPU.
"""

from __future__ import annotations

import inspect
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["build_ionic_step", "make_ionic_step", "select_route", "supports"]


class _RowNamespace:
    """``jax.numpy`` except that state arrays are lists of row blocks."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return x if isinstance(x, list) else jnp.asarray(x, *args, **kwargs)

    @staticmethod
    def stack(rows, axis=0):
        return list(rows)

    @staticmethod
    def where(cond, x, y):
        # baked parameters make switches such as ``celltype == 0`` Python
        # bools: resolve them while tracing instead of emitting a select
        if isinstance(cond, (bool, np.bool_)):
            return x if cond else y
        if isinstance(x, (int, float)) and isinstance(y, (int, float)):
            # a select between two Python constants lowers to a boolean
            # tensor on the Triton route; blend arithmetically instead
            return y if x == y else y + (x - y) * cond.astype(jnp.result_type(float))
        return jnp.where(cond, x, y)


_ROWS = _RowNamespace()


def supports(ode_fun: Callable) -> bool:
    """Whether ``ode_fun`` follows the row-wise ``xp`` convention."""
    try:
        return "xp" in inspect.signature(ode_fun).parameters
    except (TypeError, ValueError):
        return False


def build_ionic_step(
    ode_fun: Callable,
    num_states: int,
    parameters,
    v_index: int,
    *,
    block: int = 128,
    num_warps: int = 4,
    interpret: bool = False,
):
    """``step(states [S, n], v [n], t, dt) -> states'``: one call of
    ``ode_fun`` with row ``v_index`` replaced by ``v``.

    ``parameters`` is a node-uniform vector (or None), baked into the
    kernel; ``block`` (a power of two) is the number of nodes per program.
    The default, one node per thread in 128-thread programs, was the
    fastest of a sweep on an H100 (TP06 at 442,401 nodes: 33 us against
    XLA's 63 us; 2 nodes per thread or 256-thread programs were slower)."""
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    params = None if parameters is None else [float(p) for p in np.ravel(parameters)]
    S = int(num_states)

    def kernel(td_ref, s_ref, v_ref, o_ref):
        n = s_ref.shape[1]
        start = pl.program_id(0) * block
        cols = pl.ds(start, block)
        mask = start + jnp.arange(block, dtype=jnp.int32) < n
        t, dt = td_ref[0], td_ref[1]
        # row indices as int32, like the program id (also under x64)
        rows = [
            plt.load(
                (v_ref.at[cols] if r == v_index else s_ref.at[jnp.int32(r), cols]),
                mask=mask,
            )
            for r in range(S)
        ]
        out = ode_fun(rows, t, params, dt, xp=_ROWS)
        for r in range(S):
            plt.store(o_ref.at[jnp.int32(r), cols], out[r].astype(o_ref.dtype), mask=mask)

    def step(states, v, t, dt):
        td = jnp.stack([jnp.asarray(t), jnp.asarray(dt)]).astype(states.dtype)
        return pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct(states.shape, states.dtype),
            grid=(pl.cdiv(states.shape[1], block),),
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
            interpret=interpret,
            name="ionic_step",
        )(td, states, v)

    return step


def select_route(ode_fun: Callable, parameters, platform: str, route: str | None = None) -> str:
    """The ionic route of a solver whose state lives on ``platform``.

    ``route`` None picks ``"triton"`` (the compiled kernel) on a GPU when
    the model qualifies (:func:`supports`, and ``parameters`` None or one
    node-uniform vector, which the kernel bakes in), ``"xla"`` otherwise.
    ``"xla"`` forces the jnp model (A/B comparisons); ``"interpret"`` runs
    the kernel in the Pallas interpreter (tests on the CPU)."""
    if route not in (None, "xla", "interpret"):
        raise ValueError(f"ionic_kernel must be None, 'xla' or 'interpret', got {route!r}")
    qualifies = supports(ode_fun) and (parameters is None or np.ndim(parameters) == 1)
    if route is None:
        return "triton" if qualifies and platform == "gpu" else "xla"
    if route == "interpret" and not qualifies:
        raise ValueError(
            "ionic_kernel needs a model that takes `xp` and a node-uniform parameter vector"
        )
    return route


def make_ionic_step(
    ode_fun: Callable,
    num_states: int,
    parameters,
    v_index: int,
    platform: str,
    route: str | None = None,
):
    """``(route, step)``: :func:`select_route`'s choice and its
    ``step(states [S, n], v [n], t, dt) -> states'``, the ionic step with
    row ``v_index`` replaced by ``v``."""
    route = select_route(ode_fun, parameters, platform, route)
    if route != "xla":
        return route, build_ionic_step(
            ode_fun, num_states, parameters, v_index, interpret=route == "interpret"
        )

    def step(states, v, t, dt):
        return ode_fun(states=states.at[v_index].set(v), t=t, parameters=parameters, dt=dt)

    return route, step
