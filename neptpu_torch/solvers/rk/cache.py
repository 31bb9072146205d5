"""Per-shift factorization cache: NLEIGS's ``reusefact``.  Shifted solves
reuse the factorization made for the same shift value, through the port's
linear-solver layer (``ops/linsolve.py``: a dense LU on the problem's
device by default)."""
from __future__ import annotations

from ...ops.linsolve import create_linsolver, lin_solve

__all__ = ["LinSolverCache"]


class LinSolverCache:
    def __init__(self, nep, creator=None):
        self.nep = nep
        self.creator = creator
        self.cache = {}
        self.factorizations = 0  # solvers created (cached or not)

    def solve(self, shift, b, add_to_cache=True):
        key = complex(shift)
        solver = self.cache.get(key)
        if solver is None:
            solver = create_linsolver(self.creator, self.nep, key)
            self.factorizations += 1
            if add_to_cache:
                self.cache[key] = solver
        return lin_solve(solver, b)
