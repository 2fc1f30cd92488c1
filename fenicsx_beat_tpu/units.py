"""Minimal physical-unit system (pint-compatible subset).

In-repo re-implementation of the unit handling used by the reference
(``src/beat/units.py:1-10``).  The reference relies on the external ``pint``
package; here we implement a small, dependency-free registry that covers the
electrophysiology units the framework needs (S/m, uA/cm**2, uF/cm**2,
cm**-1, uA/mV, ...).

Dimensions are tracked as integer exponents over the base quantities
``(A, V, m, s)`` (ampere, volt, metre, second).  Derived electrical units are
expressed in this basis: ``S = A/V``, ``F = A*s/V``, ``ohm = V/A``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Union

__all__ = ["ureg", "to_quantity", "Quantity", "UnitRegistry"]

# exponents over base (A, V, m, s)
Dims = tuple[Fraction, Fraction, Fraction, Fraction]

_ZERO: Dims = (Fraction(0),) * 4


def _dims(A=0, V=0, m=0, s=0) -> Dims:
    return (Fraction(A), Fraction(V), Fraction(m), Fraction(s))


# base + derived units: name -> (scale to base, dims)
_UNITS: dict[str, tuple[float, Dims]] = {
    "A": (1.0, _dims(A=1)),
    "ampere": (1.0, _dims(A=1)),
    "V": (1.0, _dims(V=1)),
    "volt": (1.0, _dims(V=1)),
    "m": (1.0, _dims(m=1)),
    "meter": (1.0, _dims(m=1)),
    "metre": (1.0, _dims(m=1)),
    "s": (1.0, _dims(s=1)),
    "second": (1.0, _dims(s=1)),
    # derived electrical units
    "S": (1.0, _dims(A=1, V=-1)),
    "siemens": (1.0, _dims(A=1, V=-1)),
    "F": (1.0, _dims(A=1, V=-1, s=1)),
    "farad": (1.0, _dims(A=1, V=-1, s=1)),
    "ohm": (1.0, _dims(A=-1, V=1)),
    "C": (1.0, _dims(A=1, s=1)),
    "coulomb": (1.0, _dims(A=1, s=1)),
    "W": (1.0, _dims(A=1, V=1)),
    "Hz": (1.0, _dims(s=-1)),
    # dimensionless
    "dimensionless": (1.0, _ZERO),
    "1": (1.0, _ZERO),
}

_PREFIXES: dict[str, float] = {
    "p": 1e-12,
    "n": 1e-9,
    "u": 1e-6,
    "µ": 1e-6,
    "m": 1e-3,
    "c": 1e-2,
    "d": 1e-1,
    "da": 1e1,
    "h": 1e2,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
}


def _lookup(token: str) -> tuple[float, Dims]:
    """Resolve a unit token like ``uA`` or ``cm`` to (scale, dims)."""
    if token in _UNITS:
        return _UNITS[token]
    # try prefix + unit (longest prefix first for "da")
    for plen in (2, 1):
        if len(token) > plen:
            prefix, rest = token[:plen], token[plen:]
            if prefix in _PREFIXES and rest in _UNITS:
                scale, dims = _UNITS[rest]
                return (_PREFIXES[prefix] * scale, dims)
    raise ValueError(f"Unknown unit: {token!r}")


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)"
    r"|(?P<name>[A-Za-zµ_]+)"
    r"|(?P<op>\*\*|[*/()^])"
    r"|(?P<minus>-))"
)


class _UnitParser:
    """Recursive-descent parser for unit expressions: ``uA/cm**2``, ``S/m`` ..."""

    def __init__(self, text: str):
        self.tokens: list[str] = []
        pos = 0
        text = text.strip()
        while pos < len(text):
            mo = _TOKEN_RE.match(text, pos)
            if mo is None:
                raise ValueError(f"Cannot parse unit {text!r} at pos {pos}")
            self.tokens.append(mo.group().strip())
            pos = mo.end()
        self.i = 0

    def peek(self) -> str | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> str:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def parse(self) -> tuple[float, Dims]:
        scale, dims = self.expr()
        if self.peek() is not None:
            raise ValueError(f"Trailing tokens in unit expression: {self.tokens[self.i:]}")
        return scale, dims

    def expr(self) -> tuple[float, Dims]:
        scale, dims = self.term()
        while self.peek() in ("*", "/"):
            op = self.next()
            s2, d2 = self.term()
            if op == "*":
                scale *= s2
                dims = tuple(a + b for a, b in zip(dims, d2))  # type: ignore[assignment]
            else:
                scale /= s2
                dims = tuple(a - b for a, b in zip(dims, d2))  # type: ignore[assignment]
        return scale, dims

    def term(self) -> tuple[float, Dims]:
        scale, dims = self.atom()
        while self.peek() in ("**", "^"):
            self.next()
            exp = self.exponent()
            scale = scale**exp
            dims = tuple(a * Fraction(exp) for a in dims)  # type: ignore[assignment]
        return scale, dims

    def exponent(self) -> int:
        sign = 1
        if self.peek() == "-":
            self.next()
            sign = -1
        tok = self.next()
        return sign * int(float(tok))

    def atom(self) -> tuple[float, Dims]:
        tok = self.peek()
        if tok == "(":
            self.next()
            scale, dims = self.expr()
            if self.next() != ")":
                raise ValueError("Unbalanced parentheses in unit expression")
            return scale, dims
        tok = self.next()
        if re.fullmatch(r"[0-9.eE+-]+", tok):
            return float(tok), _ZERO
        return _lookup(tok)


def _parse_unit(text: str) -> tuple[float, Dims]:
    return _UnitParser(text).parse()


@dataclass(frozen=True)
class Quantity:
    """A scalar magnitude with physical dimensions.

    ``_base`` holds the magnitude expressed in base units (A, V, m, s);
    ``_scale``/``_unit_str`` remember the display unit so ``.magnitude``
    returns the value in the unit the user constructed it with.
    """

    _base: float
    _dims: Dims
    _scale: float = 1.0  # display-unit scale: base = magnitude * scale
    _unit_str: str = ""

    # -- constructors ----------------------------------------------------
    @staticmethod
    def from_unit(value: float, unit: str) -> "Quantity":
        scale, dims = _parse_unit(unit)
        return Quantity(value * scale, dims, scale, unit)

    # -- accessors -------------------------------------------------------
    @property
    def magnitude(self) -> float:
        return self._base / self._scale

    m = magnitude

    @property
    def units(self) -> str:
        return self._unit_str

    @property
    def dimensionless(self) -> bool:
        return all(d == 0 for d in self._dims)

    def to(self, unit: Union[str, "Quantity"]) -> "Quantity":
        if isinstance(unit, Quantity):
            unit = unit._unit_str
        scale, dims = _parse_unit(unit)
        if dims != self._dims:
            raise ValueError(
                f"Cannot convert quantity with dims {self._dims} to {unit!r} (dims {dims})"
            )
        return Quantity(self._base, dims, scale, unit)

    def to_base_units(self) -> "Quantity":
        return Quantity(self._base, self._dims, 1.0, "")

    # -- arithmetic ------------------------------------------------------
    def _wrap_mul(self, other: Union["Quantity", float, int], div: bool) -> "Quantity":
        if isinstance(other, Quantity):
            if div:
                dims = tuple(a - b for a, b in zip(self._dims, other._dims))
                base = self._base / other._base
                scale = self._scale / other._scale
                unit = f"({self._unit_str})/({other._unit_str})" if self._unit_str or other._unit_str else ""
            else:
                dims = tuple(a + b for a, b in zip(self._dims, other._dims))
                base = self._base * other._base
                scale = self._scale * other._scale
                unit = f"({self._unit_str})*({other._unit_str})" if self._unit_str or other._unit_str else ""
            return Quantity(base, dims, scale, unit)  # type: ignore[arg-type]
        if div:
            return Quantity(self._base / other, self._dims, self._scale, self._unit_str)
        return Quantity(self._base * other, self._dims, self._scale, self._unit_str)

    def __mul__(self, other):
        return self._wrap_mul(other, div=False)

    def __rmul__(self, other):
        return self._wrap_mul(other, div=False)

    def __truediv__(self, other):
        return self._wrap_mul(other, div=True)

    def __rtruediv__(self, other):
        inv = Quantity(
            1.0 / self._base,
            tuple(-a for a in self._dims),  # type: ignore[arg-type]
            1.0 / self._scale,
            f"1/({self._unit_str})",
        )
        return inv._wrap_mul(other, div=False)

    def __pow__(self, exp: int):
        return Quantity(
            self._base**exp,
            tuple(a * Fraction(exp) for a in self._dims),  # type: ignore[arg-type]
            self._scale**exp,
            f"({self._unit_str})**{exp}",
        )

    def __add__(self, other):
        if isinstance(other, Quantity):
            if other._dims != self._dims:
                raise ValueError("Cannot add quantities with different dimensions")
            return Quantity(self._base + other._base, self._dims, self._scale, self._unit_str)
        if not self.dimensionless:
            raise ValueError("Cannot add plain number to dimensional quantity")
        return Quantity(self._base + other, self._dims, self._scale, self._unit_str)

    def __sub__(self, other):
        return self.__add__(-1 * other)

    def __neg__(self):
        return Quantity(-self._base, self._dims, self._scale, self._unit_str)

    def __eq__(self, other) -> bool:  # type: ignore[override]
        if isinstance(other, Quantity):
            return self._dims == other._dims and math.isclose(
                self._base, other._base, rel_tol=1e-12, abs_tol=0.0
            )
        if self.dimensionless:
            return math.isclose(self._base, float(other), rel_tol=1e-12)
        return NotImplemented

    def __hash__(self):
        return hash((round(self._base, 15), self._dims))

    def __float__(self) -> float:
        if not self.dimensionless:
            raise ValueError("Cannot convert dimensional quantity to float")
        return self._base

    def __repr__(self) -> str:
        return f"{self.magnitude} {self._unit_str or '(base)'}"


class UnitRegistry:
    """Tiny pint-style registry: ``ureg('uA/cm**2')`` -> Quantity of 1 unit."""

    Quantity = Quantity

    def __call__(self, unit: str) -> Quantity:
        return Quantity.from_unit(1.0, unit)

    def parse_expression(self, unit: str) -> Quantity:
        return self(unit)


ureg = UnitRegistry()


def to_quantity(value: float | Quantity, unit: str) -> Quantity:
    """Coerce ``value`` to a Quantity in ``unit``.

    Mirrors the reference ``src/beat/units.py:6-10``.
    """
    if isinstance(value, Quantity):
        return value.to(unit)
    return value * ureg(unit)
