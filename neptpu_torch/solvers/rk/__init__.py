"""Rational-Krylov helpers: Leja-Bagby nodes, divided differences, the
target-set polygon, the NLEIGS coefficient expansion and the per-shift
factorization cache."""
from .utils import (evalrat, lejabagby, ratnewtoncoeffs, ratnewtoncoeffsm,
                    scgendivdiffs)
from .polygon import discretizepolygon, inpolygon
from .nleigs_coefficients import nleigs_coefficients
from .cache import LinSolverCache

__all__ = [
    "lejabagby",
    "scgendivdiffs",
    "ratnewtoncoeffs",
    "ratnewtoncoeffsm",
    "evalrat",
    "discretizepolygon",
    "inpolygon",
    "nleigs_coefficients",
    "LinSolverCache",
]
