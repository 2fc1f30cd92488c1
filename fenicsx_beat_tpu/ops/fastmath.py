"""Fast transcendentals for the ionic hot loop.

The TP06 GRL step evaluates ~58 ``exp`` per node.  The compiler's own
``exp`` is itself a range-reduced polynomial, so a hand-rolled variant is
not guaranteed to win — this module exists so the experiment can be
*measured*; it has not been measured on the GPU.

:func:`fast_exp` is the classical bit-trick exponential: range-reduce to
``exp(x) = 2^k * exp(r)`` with ``|r| <= ln2/2``, evaluate a degree-6
Taylor polynomial (relative error ~1.2e-7, at f32 resolution), and build
``2^k`` by writing the exponent bits directly — one int add + shift +
bitcast instead of a second transcendental.  Every operation (floor,
int32 convert, shift, bitcast, FMA chain) lowers to single vector
instructions, which is the entire point: the candidate win is
instruction *count*, not a cheaper approximation family.

``FASTEXP_XP`` is a drop-in array-namespace proxy (``exp`` replaced,
everything else forwarded to ``jax.numpy``) for model code written
against the ``xp`` convention
(:mod:`..models.tentusscher_panfilov_2006`), e.g.::

    ode_fun = partial(tp06.generalized_rush_larsen, xp=FASTEXP_XP)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# float32 exp underflows (to subnormal/zero) below ~-87.34; the clamp
# keeps the exponent-bit construction in the normal range and the final
# `where` makes the underflow exact instead of 2^-126-floored
_UNDERFLOW = -87.0


def fast_exp(x):
    """Bit-trick ``exp`` for float32 (other dtypes fall back to
    ``jnp.exp`` — the degree-6 polynomial only reaches f32 accuracy).

    Accuracy: relative error < 2e-7 over the normal range (gated in
    tests/test_models.py against the ionic model's argument spread);
    arguments below -87 return exactly 0.0, arguments above +88
    saturate near f32 max (the ionic model never produces them).
    """
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return jnp.exp(x)
    y = x * _LOG2E
    k = jnp.floor(y + 0.5)
    r = x - k * _LN2  # reduced argument, |r| <= ln2/2 ~ 0.3466
    # degree-6 Taylor in Horner form: remainder r^7/5040 < 1.2e-7 rel
    p = 1.0 + r * (
        1.0
        + r
        * (
            0.5
            + r
            * (
                0.16666667
                + r * (0.041666668 + r * (0.008333334 + r * 0.0013888889))
            )
        )
    )
    ki = jnp.clip(k, -126.0, 127.0).astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type(
        (ki + 127) << 23, jnp.float32
    )
    return jnp.where(x < _UNDERFLOW, 0.0, p * scale)


class _FastExpNamespace:
    """``jax.numpy`` proxy with ``exp`` swapped for :func:`fast_exp`."""

    exp = staticmethod(fast_exp)

    def __getattr__(self, name):
        return getattr(jnp, name)


FASTEXP_XP = _FastExpNamespace()
