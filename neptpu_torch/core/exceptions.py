"""Exceptions carrying partial results (reference ``src/NEPCore.jl:316-352``).

Convergence failure is modeled, not crashed: the exception carries the last
iterate ``(lam, v)`` plus the errmeasure so inner-outer solvers can catch it
and continue with partial eigenpairs (reference ``inner_solver.jl:285-292``).
"""
from __future__ import annotations

__all__ = ["NoConvergenceException", "LostOrthogonalityException"]


class NoConvergenceException(Exception):
    def __init__(self, lam=None, v=None, errmeasure=None, msg="Not converged"):
        self.lam = lam
        self.v = v
        self.errmeasure = errmeasure
        self.msg = msg
        super().__init__(msg)

    def __str__(self):
        # like the reference's showerror: avoid dumping large vectors
        return f"NoConvergenceException: {self.msg}"


class LostOrthogonalityException(Exception):
    def __init__(self, msg="Lost orthogonality"):
        self.msg = msg
        super().__init__(msg)
