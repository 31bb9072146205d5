"""Nonlinear Arnoldi (Voss): a project-expand loop with inner solves on the
projected NEP, Ritz-vector restarts (``max_subspace``,
``num_restart_ritz_vecs``) and eigenvalue sorters that reject balls of
radius R around the converged eigenvalues.

The basis ``V``, the converged vectors and every length-n product live on
the solver's device; the projected problem and its Ritz pairs on the host.
Returns ``(D, X, err_hist)``: eigenvalues and error history (numpy) and the
eigenvectors (a tensor on the device).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.errmeasure import DefaultErrmeasure, estimate_error
from ..core.nep import compute_Mlincomb
from ..models.projection import create_proj_NEP
from ..ops.linsolve import create_linsolver, lin_solve
from ..ops.orth import ModifiedGS, orthogonalize_and_normalize
from .common import (NoConvergenceException, default_tol, init_vec,
                     setup_solver, solver_device)
from .inner import inner_solve

__all__ = ["nlar", "default_eigval_sorter", "residual_eigval_sorter",
           "threshold_eigval_sorter"]

_C = torch.complex128


def _lift(Vk, y):
    """``Vk @ y`` for host coefficients ``y``, on the basis' device."""
    return Vk @ torch.as_tensor(np.asarray(y), dtype=_C, device=Vk.device)


def discard_ritz_values(dd, D, R):
    dd = np.array(dd, dtype=complex)
    for j in range(len(D)):
        dd[np.abs(dd - D[j]) < R] = np.inf
    return dd


def default_eigval_sorter(nep, dd, vv, sigma, D, R, Vk, errmeasure=None):
    dd2 = discard_ritz_values(dd, D, R)
    ii = np.argsort(np.abs(dd2 - complex(sigma)))
    return np.asarray(dd2)[ii], np.asarray(vv)[:, ii]


def _residual_sort(nep, dd, vv, sigma, D, R, Vk, errmeasure, cap):
    if errmeasure is None:
        errmeasure = DefaultErrmeasure(nep)
    dd = np.asarray(dd, dtype=complex)
    vv = np.asarray(vv)
    dd2 = discard_ritz_values(dd, D, R)
    eig_res = np.array([min(float(estimate_error(errmeasure, dd[i],
                                                 _lift(Vk, vv[:, i]))), cap)
                        for i in range(len(dd))])
    ii = np.argsort(eig_res * np.abs(dd2 - complex(sigma)))
    return dd[ii], vv[:, ii]


def residual_eigval_sorter(nep, dd, vv, sigma, D, R, Vk, errmeasure=None):
    return _residual_sort(nep, dd, vv, sigma, D, R, Vk, errmeasure, np.inf)


def threshold_eigval_sorter(nep, dd, vv, sigma, D, R, Vk, errmeasure=None,
                            threshold=0.1):
    return _residual_sort(nep, dd, vv, sigma, D, R, Vk, errmeasure,
                          threshold)


def nlar(nep, dtype=None, orthmethod=None, neigs=10, errmeasure=None,
         tol=None, maxit=100, lam=0.0, v=None, logger=0,
         linsolvercreator=None, R=0.01, eigval_sorter=residual_eigval_sorter,
         qrfact_orth=False, max_subspace=100, num_restart_ritz_vecs=8,
         inner_solver_method=None, inner_logger=0, device=None):
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    tol = default_tol(dtype) if tol is None else tol
    if orthmethod is None:
        orthmethod = ModifiedGS()
    n = nep.n
    if maxit > n:
        warnings.warn(f"Maximum iteration count maxit={maxit} larger than "
                      f"problem size n={n}. Reducing maxit.")
        maxit = n
    if num_restart_ritz_vecs > neigs:
        warnings.warn("num_restart_ritz_vecs larger than neigs; reducing.")
        num_restart_ritz_vecs = neigs
    if max_subspace < num_restart_ritz_vecs:
        warnings.warn("max_subspace smaller than num_restart_ritz_vecs; "
                      "increasing.")
        max_subspace = num_restart_ritz_vecs + 20

    sigma = complex(lam)
    nu = complex(lam)
    u = init_vec(v, n, dtype, device=device).to(_C)
    V = torch.zeros((n, max_subspace), dtype=_C, device=device)
    X = torch.zeros((n, neigs), dtype=_C, device=device)
    V[:, 0] = u / torch.linalg.vector_norm(u)
    cbs = 1
    D = np.zeros(neigs, dtype=complex)
    err_hist = np.finfo(float).eps * np.ones((maxit, neigs))
    Z = torch.zeros((n, neigs + num_restart_ritz_vecs), dtype=_C,
                    device=device)
    m = 0
    k = 1
    proj_nep = create_proj_NEP(nep, min(max_subspace + 2, n))
    linsolver = create_linsolver(linsolvercreator, nep, sigma)
    err = np.inf
    lg.info(f"Using inner solver {inner_solver_method}")

    while m < neigs and k < maxit:
        Vk = V[:, :cbs]
        proj_nep.set_projectmatrices(Vk, Vk)
        dd, vv = inner_solve(inner_solver_method, dtype, proj_nep,
                             neigs=neigs, sigma=sigma,
                             inner_logger=inner_logger)
        nuv, yv = eigval_sorter(nep, dd, vv, sigma, D[:m], R, Vk)
        nu = complex(nuv[0])
        if np.isinf(nu):
            raise RuntimeError(
                "We did not find any (non-converged) eigenvalues to target")
        u = _lift(Vk, yv[:, 0])
        u = u / torch.linalg.vector_norm(u)
        res = compute_Mlincomb(nep, nu, u)
        err = float(estimate_error(em, nu, u))
        lg.iteration(k, errs=err, lams=nu)
        err_hist[k - 1, m] = err
        if err < tol:
            lg.info(f"****** {m + 1} converged to eigenvalue: {nu} "
                    f"errmeasure:{err}")
            D[m] = nu
            X[:, m] = u
            m += 1
            nuv, yv = eigval_sorter(nep, dd, vv, sigma, D[:m], R, Vk)
            u1 = _lift(Vk, yv[:, 0])
            res = compute_Mlincomb(nep, complex(nuv[0]),
                                   u1 / torch.linalg.vector_norm(u1))
        if Vk.shape[1] >= max_subspace:
            # restart with the converged eigenvectors + best Ritz vectors
            cbs = m + num_restart_ritz_vecs
            Z[:, :m] = X[:, :m]
            Z[:, m:cbs] = _lift(Vk, yv[:, :num_restart_ritz_vecs])
            V[:, :cbs] = torch.linalg.qr(Z[:, :cbs])[0]
        else:
            dv = lin_solve(linsolver, res).to(_C)
            if qrfact_orth:
                cbs += 1
                V[:, :cbs] = torch.linalg.qr(
                    torch.cat([Vk, dv[:, None]], dim=1))[0]
            else:
                vout, _, _ = orthogonalize_and_normalize(Vk, dv, orthmethod)
                cbs += 1
                V[:, cbs - 1] = vout
        k += 1

    if k >= maxit and m < neigs:
        msg = (f"Number of iterations exceeded. maxit={maxit} and only {m} "
               f"eigenvalues converged out of {neigs}.")
        raise NoConvergenceException(nu, u, err, msg)
    return D, X, err_hist
