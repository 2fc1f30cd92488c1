"""Compute kernels: quadrature, sparse operators, CG, preconditioners, the
ionic Pallas kernel."""

from . import cg, quadrature, sparse  # noqa: F401
