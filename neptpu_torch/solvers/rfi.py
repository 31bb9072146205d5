"""Two-sided Rayleigh functional iteration: ``rfi`` and the bordered
variant ``rfi_b`` (Schreiber 2008, Alg. 5); both take the transposed NEP.
The eigenvalue iterate is a host scalar, the vectors tensors on the
solver's device."""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mder, compute_Mlincomb
from ..ops.linsolve import (BackslashLinSolverCreator, create_linsolver,
                            lin_solve)
from .common import (NoConvergenceException, closest_to, init_vec,
                     scalar_as, setup_solver, solver_device, vec_as)
from .rf import compute_rf

__all__ = ["rfi", "rfi_b"]

_ONE = np.ones(1)


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def _start(nep, dtype, errmeasure, logger, tol, v, u, device):
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = 1000 * float(torch.finfo(real_of(dtype)).eps)
    n = nep.n
    v = init_vec(v, n, dtype, seed=3, device=device)
    u = init_vec(u, n, dtype, seed=4, device=device)
    return (dtype, em, lg, tol, v / torch.linalg.vector_norm(v),
            u / torch.linalg.vector_norm(u))


def _unit(x, dtype):
    return vec_as(x / torch.linalg.vector_norm(x), dtype)


def _exceeded(lam, u, err, maxit):
    return NoConvergenceException(
        lam, u, err, f"Number of iterations exceeded. maxit={maxit}.")


def rfi(nep, nept, dtype=None, errmeasure=None, tol=None, maxit=100, lam=0.0,
        v=None, u=None, linsolvercreator=None, inner_solver=None, logger=0,
        device=None):
    dtype, em, lg, tol, v, u = _start(nep, dtype, errmeasure, logger, tol, v,
                                      u, device)
    lam = scalar_as(lam, dtype)
    if linsolvercreator is None:
        linsolvercreator = BackslashLinSolverCreator()
    err = np.inf
    for k in range(maxit):
        err = estimate_error(em, lam, u)
        if float(err) < tol:
            return lam, u, v
        lg.iteration(k, errs=err, lams=lam)
        ls = create_linsolver(linsolvercreator, nep, lam)
        ls_t = create_linsolver(linsolvercreator, nept, lam)
        x = lin_solve(ls, compute_Mlincomb(nep, lam, u[:, None], _ONE,
                                           startder=1), tol=tol)
        u = _unit(x, dtype)
        y = lin_solve(ls_t, compute_Mlincomb(nept, lam, v[:, None], _ONE,
                                             startder=1), tol=tol)
        v = _unit(y, dtype)
        lam_vec = compute_rf(dtype, nep, u, inner_solver, y=v)
        lam = scalar_as(closest_to(lam_vec, lam), dtype)
    raise _exceeded(lam, u, err, maxit)


def rfi_b(nep, nept, dtype=None, errmeasure=None, tol=None, maxit=100,
          lam=0.0, v=None, u=None, inner_solver=None, logger=0, device=None):
    """Bordered variant: one (n+1) x (n+1) dense solve per vector."""
    dtype, em, lg, tol, v, u = _start(nep, dtype, errmeasure, logger, tol, v,
                                      u, device)
    lam = scalar_as(lam, dtype)
    err = np.inf
    for k in range(maxit):
        err = estimate_error(em, lam, u)
        if float(err) < tol:
            return lam, u, v
        lg.iteration(k, errs=err, lams=lam)
        M = _dense(compute_Mder(nep, lam, 0)).to(dtype)
        Mdu = compute_Mlincomb(nep, lam, u[:, None], _ONE, startder=1)
        vMd = torch.conj(v) @ _dense(compute_Mder(nep, lam, 1)).to(dtype)
        zero = torch.zeros((1, 1), dtype=dtype, device=M.device)
        C = torch.cat([torch.cat([M, Mdu[:, None].to(dtype)], dim=1),
                       torch.cat([vMd[None, :], zero], dim=1)])
        r1 = torch.cat([compute_Mlincomb(nep, lam, u[:, None], _ONE).to(dtype),
                        zero[0]])
        u = _unit(u + torch.linalg.solve(C, -r1)[:-1], dtype)
        r2 = torch.cat([compute_Mlincomb(nept, lam, v[:, None],
                                         _ONE).to(dtype), zero[0]])
        v = _unit(v + torch.linalg.solve(C, -r2)[:-1], dtype)
        lam_vec = compute_rf(dtype, nep, u, inner_solver, y=v)
        lam = scalar_as(closest_to(lam_vec, lam), dtype)
    raise _exceeded(lam, u, err, maxit)
