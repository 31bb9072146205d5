"""Safeguarded iteration for Hermitian NEPs: the j-th eigenvalue by the
min-max ordering, a full eigensolve of M(lam) and a Rayleigh-functional
update per iteration."""
from __future__ import annotations

import numpy as np
import torch

from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mder
from ..ops.eigsolve import DefaultEigSolver, eig_solve
from .common import (NoConvergenceException, default_tol, setup_solver,
                     solver_device, vec_as)
from .rf import compute_rf

__all__ = ["sgiter"]


def sgiter(nep, j, dtype=None, lam_min=np.nan, lam_max=np.nan, lam=0.0,
           errmeasure=None, tol=None, maxit=100, inner_solver=None, logger=0,
           eigsolvertype=DefaultEigSolver, device=None):
    solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    tol = default_tol(dtype) if tol is None else tol
    n = nep.n
    if j > n or j <= 0:
        raise ValueError(
            f"j must be between 1 and size(nep) = {n}; got j = {j}")
    has_min = not np.isnan(lam_min)
    has_max = not np.isnan(lam_max)
    if has_min != has_max:
        raise ValueError("A proper interval is not chosen.")
    if has_min and lam_max < lam_min:
        raise ValueError(
            "The interval cannot be empty, lam_max >= lam_min required.")
    lam = float(np.real(lam))
    if has_min and (lam < lam_min or lam > lam_max):
        raise ValueError("The starting guess is outside the interval.")
    v = None
    err = np.inf
    for k in range(maxit):
        L, V = eig_solve(eigsolvertype(compute_Mder(nep, lam, 0)), nev=n)
        p = torch.argsort(L.real)
        v = vec_as(V[:, p[j - 1]], dtype)
        lam_vec = np.real(np.atleast_1d(
            compute_rf(torch.float64, nep, v, inner_solver)))
        lg.info(f"compute_rf: {lam_vec}", level=2)
        if not has_min:
            lam = float(np.min(lam_vec))
        else:
            inside = lam_vec[(lam_vec >= lam_min) & (lam_vec <= lam_max)]
            if inside.size > 1:
                raise ValueError(
                    "Multiple values of lambda found in the interval.")
            if inside.size == 0:
                raise ValueError("No lambda found in the prescribed interval.")
            lam = float(inside[0])
        err = estimate_error(em, lam, v)
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return lam, v
    raise NoConvergenceException(
        lam, v, err, f"Number of iterations exceeded. maxit={maxit}.")
