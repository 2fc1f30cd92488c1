"""Runtime gotran ``.ode`` ingestion: parse -> generate a jittable
cell-model module.

The reference compiles arbitrary gotran ODE files to stepping code *at
demo runtime* with gotranx (``/root/reference/demos/
niederer_benchmark.py:75-88``; model data in ``/root/reference/odes/``).
This module is the JAX equivalent of that L9 function: it parses
the gotran declaration subset those files use and emits a Python module
with the exact gotranx module contract the ODE solvers consume
(``init_state_values`` / ``init_parameter_values`` / ``state_index`` /
``parameter_index`` / ``rhs`` / ``forward_euler`` /
``generalized_rush_larsen``), except the generated arithmetic is
``jax.numpy`` — jit/vmap/grad-able, and accepted by the fused solvers
like the hand-written in-repo models.

**Format.**  A gotran file is syntactically valid Python: declaration
calls ``states("Section", name=value, ...)``, ``parameters(...)`` (with
optional ``ScalarParam(value, unit=...)`` wrappers) and
``expressions("Section"[, "Sub"])`` group headers, followed by plain
assignments ``name = expr`` where ``d<state>_dt = ...`` define the state
derivatives.  Expressions use ``exp/log/sqrt/floor/Abs``, the sympy-
style relationals ``Eq/Ne/Ge/Gt/Le/Lt``, ``And/Or/Not`` and
``Conditional(cond, then, otherwise)``; the symbol ``time`` is the
solver-supplied ``t``.  We therefore parse with :mod:`ast` (no
hand-rolled tokenizer) and reject anything outside this subset.

**Scheme.**  ``generalized_rush_larsen`` is first-order GRL1 with the
gotranx linearization convention: each state's stated derivative
expression is differentiated with respect to its own state symbol with
intermediate variables held fixed, giving the classical Rush-Larsen
exponential update on Hodgkin-Huxley gates (``dx_dt = (x_inf - x)/tau``
-> ``lin = -1/tau``) and on linear kinetics (ToR-ORd's ``R_prime``-style
states), and an explicit Euler update where the self-derivative
vanishes (V, most concentrations) — the same split the hand-written
in-repo models implement (``models/tentusscher_panfilov_2006.py:481``),
which is the tolerance gate in ``tests/test_odefile.py``.
"""

from __future__ import annotations

import ast
import types
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["ParsedODE", "parse_ode", "generate_code", "load_ode"]

_DECLS = {"states", "parameters", "expressions"}
_RESERVED = {"states", "parameters", "t", "dt", "time"}


@dataclass
class ParsedODE:
    """Declaration-ordered parse of one gotran file."""

    name: str
    states: list[tuple[str, float]] = field(default_factory=list)
    parameters: list[tuple[str, float]] = field(default_factory=list)
    # (lhs name, ast expression, section label) in file order;
    # derivative assignments (``d<state>_dt``) are included
    assignments: list[tuple[str, ast.expr, str]] = field(default_factory=list)

    @property
    def state_names(self) -> list[str]:
        return [n for n, _ in self.states]

    @property
    def parameter_names(self) -> list[str]:
        return [n for n, _ in self.parameters]


def _literal_value(node: ast.expr, path: str) -> float:
    """Numeric value of a declaration default: a constant, ``-const``,
    or ``ScalarParam(value, unit=..., ...)``."""
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "ScalarParam"
    ):
        if not node.args:
            raise ValueError(f"{path}: ScalarParam with no value")
        node = node.args[0]
    try:
        v = ast.literal_eval(node)
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"{path}: unsupported declaration value "
            f"{ast.dump(node)[:80]}"
        ) from e
    return float(v)


def parse_ode(source: str | Path, name: str | None = None) -> ParsedODE:
    """Parse gotran text or a ``.ode`` file path."""
    if isinstance(source, Path) or (
        isinstance(source, str) and "\n" not in source and source.endswith(".ode")
    ):
        path = str(source)
        text = Path(source).read_text()
        if name is None:
            name = Path(source).stem
    else:
        path = "<ode text>"
        text = str(source)
        name = name or "ode_model"

    tree = ast.parse(text)
    parsed = ParsedODE(name=name)
    seen: set[str] = set()
    section = ""
    for node in tree.body:
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            fname = call.func.id if isinstance(call.func, ast.Name) else None
            if fname not in _DECLS:
                raise ValueError(
                    f"{path}:{node.lineno}: unknown declaration {fname!r}"
                )
            labels = [
                a.value
                for a in call.args
                if isinstance(a, ast.Constant) and isinstance(a.value, str)
            ]
            section = ", ".join(labels)
            target = (
                parsed.states if fname == "states"
                else parsed.parameters if fname == "parameters"
                else None
            )
            if target is None:
                continue  # expressions(...) is a group header only
            for kw in call.keywords:
                if kw.arg is None:
                    raise ValueError(f"{path}:{node.lineno}: **kwargs in {fname}")
                if kw.arg in seen:
                    raise ValueError(
                        f"{path}:{node.lineno}: duplicate declaration {kw.arg!r}"
                    )
                if kw.arg in _RESERVED or kw.arg.startswith("_"):
                    raise ValueError(
                        f"{path}:{node.lineno}: reserved name {kw.arg!r}"
                    )
                seen.add(kw.arg)
                target.append((kw.arg, _literal_value(kw.value, path)))
        elif isinstance(node, ast.Assign):
            if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
                raise ValueError(
                    f"{path}:{node.lineno}: only single-name assignments"
                )
            lhs = node.targets[0].id
            if lhs in seen:
                # tolerate byte-identical re-declarations (the reference's
                # ToRORd Land file repeats Aw/As verbatim at :683 and
                # :705 — a generation artifact); conflicting ones error
                prev = next(
                    (e for n_, e, _ in parsed.assignments if n_ == lhs), None
                )
                if prev is not None and ast.dump(prev) == ast.dump(node.value):
                    continue
                raise ValueError(f"{path}:{node.lineno}: reassignment of {lhs!r}")
            if lhs in _RESERVED or lhs.startswith("_"):
                raise ValueError(f"{path}:{node.lineno}: reserved name {lhs!r}")
            seen.add(lhs)
            parsed.assignments.append((lhs, node.value, section))
        else:
            raise ValueError(
                f"{path}:{node.lineno}: unsupported statement "
                f"{type(node).__name__}"
            )

    missing = [
        s for s in parsed.state_names if f"d{s}_dt" not in seen
    ]
    if missing:
        raise ValueError(f"{path}: states with no d<state>_dt: {missing}")
    return parsed


# ----------------------------------------------------------------------
# ast -> sympy
# ----------------------------------------------------------------------
def _sympy_funcs():
    import sympy as sp

    def conditional(c, a, b):
        return sp.Piecewise((a, c), (b, True))

    return {
        "exp": sp.exp, "log": sp.log, "sqrt": sp.sqrt, "floor": sp.floor,
        "Abs": sp.Abs, "Conditional": conditional,
        "Eq": sp.Eq, "Ne": sp.Ne, "Ge": sp.Ge, "Gt": sp.Gt,
        "Le": sp.Le, "Lt": sp.Lt,
        "And": sp.And, "Or": sp.Or, "Not": sp.Not,
    }


def _as_numeric(expr):
    """Gotran files use relationals as 0/1 masks in arithmetic (ToR-ORd
    Land: ``Gt(Zetas, 0)*Zetas``); sympy relationals don't multiply —
    lower them to an explicit indicator Piecewise."""
    import sympy as sp

    if expr is sp.true:
        return sp.Integer(1)
    if expr is sp.false:
        return sp.Integer(0)
    if isinstance(
        expr, (sp.core.relational.Relational, sp.logic.boolalg.BooleanFunction)
    ):
        return sp.Piecewise((1, expr), (0, True))
    return expr


def _to_sympy(node: ast.expr, symbols: dict, funcs: dict):
    import sympy as sp

    if isinstance(node, ast.Constant):
        v = node.value
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"unsupported constant {v!r}")
        return sp.Integer(v) if isinstance(v, int) else sp.Float(v)
    if isinstance(node, ast.Name):
        try:
            return symbols[node.id]
        except KeyError:
            raise ValueError(
                f"symbol {node.id!r} used before definition"
            ) from None
    if isinstance(node, ast.UnaryOp):
        val = _as_numeric(_to_sympy(node.operand, symbols, funcs))
        if isinstance(node.op, ast.USub):
            return -val
        if isinstance(node.op, ast.UAdd):
            return val
        raise ValueError(f"unsupported unary op {type(node.op).__name__}")
    if isinstance(node, ast.BinOp):
        a = _as_numeric(_to_sympy(node.left, symbols, funcs))
        b = _as_numeric(_to_sympy(node.right, symbols, funcs))
        op = type(node.op)
        if op is ast.Add:
            return a + b
        if op is ast.Sub:
            return a - b
        if op is ast.Mult:
            return a * b
        if op is ast.Div:
            return a / b
        if op is ast.Pow:
            return a ** b
        raise ValueError(f"unsupported operator {op.__name__}")
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        fn = funcs.get(node.func.id)
        if fn is None:
            raise ValueError(f"unsupported function {node.func.id!r}")
        args = [_to_sympy(a, symbols, funcs) for a in node.args]
        return fn(*args)
    if isinstance(node, ast.Compare) and len(node.ops) == 1:
        a = _to_sympy(node.left, symbols, funcs)
        b = _to_sympy(node.comparators[0], symbols, funcs)
        rel = {
            ast.Lt: sp.Lt, ast.LtE: sp.Le, ast.Gt: sp.Gt,
            ast.GtE: sp.Ge, ast.Eq: sp.Eq, ast.NotEq: sp.Ne,
        }.get(type(node.ops[0]))
        if rel is None:
            raise ValueError("unsupported comparison")
        return rel(a, b)
    raise ValueError(f"unsupported expression {type(node).__name__}")


# ----------------------------------------------------------------------
# codegen
# ----------------------------------------------------------------------
_HEADER = '''"""Generated from {name}.ode by fenicsx_beat_tpu.odefile.

gotranx-compatible module contract (the reference generates the same
surface at demo runtime: /root/reference/demos/niederer_benchmark.py:
75-88); arithmetic is jax.numpy so the module jit/vmap/grads and feeds
the fused solvers unchanged.
"""
import jax
import jax.numpy
import numpy as np

'''

_INDEX_FNS = '''
def state_index(name: str) -> int:
    return _STATE_NAMES.index(name)


def parameter_index(name: str) -> int:
    return _PARAM_NAMES.index(name)


def init_state_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_STATE_NAMES)
    if unknown:
        raise KeyError(f"Unknown state name(s): {sorted(unknown)}")
    out = _STATE_INIT.copy()
    for k, v in overrides.items():
        out[state_index(k)] = v
    return out


def init_parameter_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_PARAM_NAMES)
    if unknown:
        raise KeyError(f"Unknown parameter name(s): {sorted(unknown)}")
    out = _PARAM_INIT.copy()
    for k, v in overrides.items():
        out[parameter_index(k)] = v
    return out

'''


def generate_code(parsed: ParsedODE, grl_eps: float = 1e-8) -> str:
    """Emit the module source for a :class:`ParsedODE`."""
    import sympy as sp
    from sympy.printing.numpy import JaxPrinter

    printer = JaxPrinter()
    funcs = _sympy_funcs()
    symbols: dict = {"time": sp.Symbol("t")}
    for n, _ in parsed.states + parsed.parameters:
        symbols[n] = sp.Symbol(n)

    # gotran permits forward references (ToR-ORd declares Ageo after its
    # first use): topologically order the assignment DAG, file-order-
    # stable among independents (gotranx does the same sort)
    ast_of = {lhs: e for lhs, e, _ in parsed.assignments}
    order: list[str] = []
    state_mark: dict[str, int] = {}  # 1 = in progress, 2 = done

    def visit(name: str, chain: tuple = ()):  # iterative-enough: depth
        if state_mark.get(name) == 2:  # ~ expression nesting, not file size
            return
        if state_mark.get(name) == 1:
            raise ValueError(f"circular definition through {name!r}")
        state_mark[name] = 1
        for node in ast.walk(ast_of[name]):
            if isinstance(node, ast.Name) and node.id in ast_of:
                visit(node.id)
        state_mark[name] = 2
        order.append(name)

    for lhs, _, _ in parsed.assignments:
        visit(lhs)

    sym_assignments: list[tuple[str, object]] = []
    for lhs in order:
        expr = _to_sympy(ast_of[lhs], symbols, funcs)
        symbols[lhs] = sp.Symbol(lhs)
        sym_assignments.append((lhs, expr))
    deriv_exprs = dict(sym_assignments)

    def emit_body(lines: list[str]) -> None:
        for i, (n, _) in enumerate(parsed.states):
            lines.append(f"    {n} = states[{i}]")
        for i, (n, _) in enumerate(parsed.parameters):
            lines.append(f"    {n} = parameters[{i}]")
        for lhs, expr in sym_assignments:
            lines.append(f"    {lhs} = {printer.doprint(expr)}")

    state_names = parsed.state_names
    stack = ", ".join(f"d{s}_dt" for s in state_names)

    out = [_HEADER.format(name=parsed.name)]
    out.append(f"_STATE_NAMES = {tuple(state_names)!r}")
    out.append(f"_PARAM_NAMES = {tuple(parsed.parameter_names)!r}")
    out.append(
        "_STATE_INIT = np.array(["
        + ", ".join(repr(v) for _, v in parsed.states)
        + "])"
    )
    out.append(
        "_PARAM_INIT = np.array(["
        + ", ".join(repr(v) for _, v in parsed.parameters)
        + "])"
    )
    out.append(_INDEX_FNS)

    lines = ["def rhs(states, t, parameters):"]
    lines.append('    """d(states)/dt, shape (num_states, ...)."""')
    emit_body(lines)
    lines.append(f"    return jax.numpy.stack([{stack}])")
    out.append("\n".join(lines) + "\n")

    lines = ["def forward_euler(states, t, parameters, dt, **kwargs):"]
    lines.append("    states = jax.numpy.asarray(states)")
    lines.append("    return states + dt * rhs(states, t, parameters)")
    out.append("\n".join(lines) + "\n")

    lines = ["def generalized_rush_larsen(states, t, parameters, dt, **kwargs):"]
    lines.append(
        '    """GRL1: exponential update where the self-derivative of the\n'
        "    stated d<state>_dt (intermediates held fixed) is nonzero,\n"
        '    explicit Euler elsewhere (gotranx convention)."""'
    )
    emit_body(lines)
    news = []
    for s in state_names:
        d = f"d{s}_dt"
        expr = deriv_exprs[d]
        lin = sp.diff(expr, symbols[s])
        if lin.has(sp.Derivative):
            lin = sp.S.Zero  # non-differentiable (floor etc.): Euler
        if lin == 0:
            lines.append(f"    _new_{s} = {s} + dt * {d}")
        else:
            lines.append(f"    _lin_{s} = {printer.doprint(lin)}")
            lines.append(
                f"    _new_{s} = jax.numpy.where("
                f"jax.numpy.abs(_lin_{s}) > {grl_eps!r}, "
                f"{s} + jax.numpy.expm1(dt * _lin_{s}) * {d} / "
                f"jax.numpy.where(jax.numpy.abs(_lin_{s}) > {grl_eps!r}, "
                f"_lin_{s}, 1.0), "
                f"{s} + dt * {d})"
            )
        news.append(f"_new_{s}")
    lines.append(f"    return jax.numpy.stack([{', '.join(news)}])")
    out.append("\n".join(lines) + "\n")
    return "\n".join(out)


def load_ode(source: str | Path, name: str | None = None) -> types.ModuleType:
    """Parse + codegen + exec: returns a module object with the gotranx
    contract.  The generated source is attached as ``module.code`` (the
    reference's pattern writes it next to the demo; do the same with
    ``Path(...).write_text(model.code)`` if you want the file)."""
    parsed = parse_ode(source, name=name)
    code = generate_code(parsed)
    mod = types.ModuleType(parsed.name)
    mod.__dict__["__file__"] = f"<generated from {parsed.name}.ode>"
    exec(compile(code, mod.__file__, "exec"), mod.__dict__)
    mod.code = code
    mod.num_states = len(parsed.states)
    mod.num_parameters = len(parsed.parameters)
    return mod
