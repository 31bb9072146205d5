"""Method of successive linear problems: one generalized eigensolve of the
pencil ``(M(lam), M'(lam))`` per iteration.  The eigenvalue iterate is a
host scalar, the vector a tensor on the solver's device."""
from __future__ import annotations

import numpy as np
import torch

from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mder
from ..ops.eigsolve import DefaultEigSolver, eig_solve
from .common import (NoConvergenceException, default_tol, scalar_as,
                     setup_solver, solver_device, vec_as)

__all__ = ["mslp"]


def mslp(nep, dtype=None, errmeasure=None, tol=None, maxit=100, lam=0.0,
         logger=0, eigsolvertype=DefaultEigSolver, device=None):
    solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    tol = default_tol(dtype) if tol is None else tol
    lam = scalar_as(lam, dtype)
    v = None
    err = np.inf
    for k in range(maxit):
        solver = eigsolvertype(compute_Mder(nep, lam, 0),
                               compute_Mder(nep, lam, 1))
        d, V = eig_solve(solver, target=0.0, nev=1)
        lam = scalar_as(lam - complex(d[0]), dtype)
        v = vec_as(V[:, 0] / torch.linalg.vector_norm(V[:, 0]), dtype)
        err = estimate_error(em, lam, v)
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return lam, v
    raise NoConvergenceException(
        lam, v, err, f"Number of iterations exceeded. maxit={maxit}.")
