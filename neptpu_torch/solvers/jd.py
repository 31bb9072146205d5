"""Jacobi-Davidson: ``jd_betcke`` (Petrov-Galerkin or Galerkin projection,
rank-1 border expansion of the projected NEP per iteration) and
``jd_effenberger`` (JD with Effenberger deflation: converge, deflate the
pair, restart the inner JD on the deflated NEP with the Schur-complement
``DeflatedNEPLinSolver``).

The search spaces ``V``, ``W`` and every length-n product live on the
solver's device; the projected problem and its Ritz pairs on the host.
Both return ``(lams, U)``: eigenvalues (numpy) and eigenvectors (a tensor on
the device).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb
from ..models.deflation import deflate_eigpair, get_deflated_eigpairs
from ..models.projection import create_proj_NEP
from ..ops.linsolve import (DeflatedNEPLinSolverCreator, create_linsolver,
                            lin_solve)
from ..ops.orth import DGKS, orthogonalize_and_normalize
from .common import (NoConvergenceException, default_tol, init_vec,
                     setup_solver, solver_device)
from .inner import SGIterInnerSolver, inner_solve

__all__ = ["jd_betcke", "jd_effenberger"]

_C = torch.complex128
_ONE = np.ones(1)


def jd_eig_sorter(lamv, V, N, target):
    """The N-th closest to ``target`` of the Ritz pairs ``(lamv, V)``."""
    lamv = np.atleast_1d(np.asarray(lamv))
    NN = min(N, len(lamv))
    c = np.argsort(np.abs(lamv - complex(target)))
    return complex(lamv[c[NN - 1]]), np.asarray(V)[:, c[NN - 1]]


def _unit(x):
    return x / torch.linalg.vector_norm(x)


def _lift(V, s):
    return V @ torch.as_tensor(s, dtype=_C, device=V.device)


def _orth(V, w, orthmethod):
    return orthogonalize_and_normalize(V, w.to(_C), orthmethod)[0]


def _exceeded(maxit, conveig, neigs):
    return (f"Number of iterations exceeded. maxit={maxit} and only "
            f"{conveig} eigenvalues converged out of {neigs}.")


def jd_betcke(nep, dtype=None, maxit=100, neigs=1,
              projtype=":PetrovGalerkin", inner_solver_method=None,
              orthmethod=None, errmeasure=None, linsolvercreator=None,
              tol=None, lam=0.0, v=None, target=0.0, logger=0,
              inner_logger=0, device=None):
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    tol = default_tol(dtype) if tol is None else tol
    if orthmethod is None:
        orthmethod = DGKS()
    n = nep.n
    if maxit > n:
        raise ValueError(f"maxit = {maxit} is larger than size of NEP = {n}.")
    if projtype not in (":Galerkin", ":PetrovGalerkin"):
        raise ValueError("Only accepted values of 'projtype' are :Galerkin "
                         "and :PetrovGalerkin.")
    if (projtype != ":Galerkin"
            and isinstance(inner_solver_method, SGIterInnerSolver)):
        raise ValueError("Need to use 'projtype' :Galerkin in order to use "
                         "SGITER as inner solver.")
    lam = complex(lam)
    target = complex(target)
    lam_vec = np.zeros(neigs, dtype=complex)
    u_vec = torch.zeros((n, neigs), dtype=_C, device=device)
    u = _unit(init_vec(v, n, dtype, device=device).to(_C))
    conveig = 0
    err = float(estimate_error(em, lam, u))
    if err < tol:
        conveig += 1
        lam_vec[conveig - 1] = lam
        u_vec[:, conveig - 1] = u
    if conveig == neigs:
        return lam_vec, u_vec

    proj_nep = create_proj_NEP(nep, maxit)
    V_mem = torch.zeros((n, maxit + 1), dtype=_C, device=device)
    V_mem[:, 0] = u
    petrov = projtype == ":PetrovGalerkin"
    if petrov:
        W_mem = torch.zeros((n, maxit + 1), dtype=_C, device=device)
        W_mem[:, 0] = _unit(compute_Mlincomb(nep, lam, u).to(_C))
    else:
        W_mem = V_mem

    for k in range(1, maxit + 1):
        V = V_mem[:, :k]
        W = W_mem[:, :k]
        if k == 1:
            proj_nep.set_projectmatrices(W, V)
        else:
            proj_nep.expand_projectmatrices(W, V)
        lamv, sv = inner_solve(inner_solver_method, dtype, proj_nep,
                               j=conveig + 1,
                               lamv=lam * np.ones(conveig + 1), sigma=target,
                               neigs=conveig + 1, inner_logger=inner_logger)
        lam, s = jd_eig_sorter(lamv, sv, conveig + 1, target)
        u = _lift(V, s / np.linalg.norm(s))
        err = float(estimate_error(em, lam, u))
        lg.iteration(k, errs=err, lams=lam)
        if err < tol and (
            conveig == 0
            or np.all(np.abs(lam - lam_vec[:conveig])
                      / np.abs(lam_vec[:conveig])
                      > np.finfo(float).eps ** 0.25)
        ):
            conveig += 1
            lam_vec[conveig - 1] = lam
            u_vec[:, conveig - 1] = u
        if conveig == neigs:
            return lam_vec, u_vec

        pk = compute_Mlincomb(nep, lam, u[:, None], _ONE, startder=1)
        linsolver = create_linsolver(linsolvercreator, nep, lam)
        V_mem[:, k] = _orth(V, lin_solve(linsolver, pk, tol=tol),
                            orthmethod)
        if petrov:
            W_mem[:, k] = _orth(W, compute_Mlincomb(nep, lam, u), orthmethod)

    raise NoConvergenceException(
        np.concatenate([lam_vec[:conveig], [lam]]),
        torch.cat([u_vec[:, :conveig], u[:, None]], dim=1), err,
        _exceeded(maxit, conveig, neigs))


def jd_effenberger(nep, dtype=None, maxit=100, neigs=1,
                   inner_solver_method=None, orthmethod=None,
                   linsolvercreator=None, tol=None, lam=None, v=None,
                   target=0.0, deflation_mode=":Auto", logger=0,
                   inner_logger=0, device=None):
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, None, logger)
    tol = default_tol(dtype) if tol is None else tol
    if orthmethod is None:
        orthmethod = DGKS()
    n = nep.n
    if maxit > n:
        raise ValueError(f"maxit = {maxit} is larger than size of NEP = {n}.")
    if isinstance(inner_solver_method, SGIterInnerSolver):
        raise ValueError("Inner solver 'SGIterInnerSolver' not accepted since "
                         "deflated problem not min-max.")
    rng = np.random.default_rng(1)
    lam = complex(rng.random()) if lam is None else complex(lam)
    u = _unit(init_vec(v, n, dtype, seed=2, device=device).to(_C))
    target = complex(target)
    conveig = 0
    tot_its = 0
    lam_init, u_init = lam, u
    args = (inner_solver_method, orthmethod)

    err = float(torch.linalg.vector_norm(compute_Mlincomb(nep, lam, u)))
    if err >= tol:
        lam, u, tot_its, u_init, lam_init = _jd_eff_inner(
            nep, None, maxit, tot_its, conveig, *args, linsolvercreator, tol,
            target, lg, neigs, u, lam, inner_logger, dtype)
    conveig += 1
    dnep = deflate_eigpair(nep, lam, u, mode=deflation_mode)

    while True:
        if conveig == neigs:
            return get_deflated_eigpairs(dnep)
        dls = DeflatedNEPLinSolverCreator(linsolvercreator)
        lam, u, tot_its, u_init, lam_init = _jd_eff_inner(
            dnep, dnep, maxit, tot_its, conveig, *args, dls, tol, target, lg,
            neigs, u_init, lam_init, inner_logger, dtype)
        conveig += 1
        dnep = deflate_eigpair(dnep, lam, u)


def _jd_eff_inner(target_nep, dnep, maxit, nrof_its, conveig,
                  inner_solver_method, orthmethod, linsolvercreator, tol,
                  target, lg, neigs, u, lam, inner_logger, dtype):
    """One deflation level of JD; returns ``(lam, u, iterations so far,
    next start vector, next start value)``."""
    if dnep is None:
        orgnep, m = target_nep, 0
    else:
        orgnep, m = dnep.orgnep, dnep.p
    n = orgnep.n
    nm = n + m
    device = dnep.V0_t.device if dnep is not None else u.device
    u = torch.as_tensor(u, device=device).to(_C)[:nm]
    if len(u) < nm:
        u = torch.cat([u, torch.zeros(nm - len(u), dtype=_C, device=device)])
    u = _unit(u)
    lam = complex(np.asarray(lam).ravel()[0])
    rng = np.random.default_rng(7)
    newton_step = torch.as_tensor(rng.random(nm), dtype=_C, device=device)
    cap = maxit + 1 - nrof_its
    proj_nep = create_proj_NEP(target_nep, cap)
    V_mem = torch.zeros((nm, cap), dtype=_C, device=device)
    W_mem = torch.zeros((nm, cap), dtype=_C, device=device)
    V_mem[:, 0] = u
    W_mem[:, 0] = _unit(compute_Mlincomb(target_nep, lam, u).to(_C))
    err = np.inf
    for loop_counter in range(nrof_its + 1, maxit + 1):
        k = loop_counter - nrof_its
        V = V_mem[:, :k]
        W = W_mem[:, :k]
        proj_nep.set_projectmatrices(W, V)
        lamv, sv = inner_solve(inner_solver_method, dtype, proj_nep,
                               tol=tol / 10, lamv=lam * np.ones(2),
                               sigma=target, neigs=2,
                               inner_logger=inner_logger)
        lam_temp, s = jd_eig_sorter(lamv, sv, 1, target)
        s = s / np.linalg.norm(s)
        projres = float(torch.linalg.vector_norm(compute_Mlincomb(
            proj_nep, lam_temp, torch.as_tensor(s[:k]))))
        if (not np.isnan(lam_temp) and not np.any(np.isnan(s[:k]))
                and projres < tol * 50):
            u = _lift(V, s)
            lam = lam_temp
        else:
            u = _unit(u + newton_step)
        rk = compute_Mlincomb(target_nep, lam, u).to(_C)
        err = float(torch.linalg.vector_norm(rk))
        lg.iteration(loop_counter, errs=err, lams=lam)
        if err < tol:
            lg.info("One eigenvalue converged." + (
                " Deflating and restarting." if conveig + 1 < neigs else ""))
            lam2, s2 = jd_eig_sorter(lamv, sv, 2, target)
            if (np.asarray(sv).shape[1] > 1
                    and abs(lam - lam2) / abs(lam) > np.sqrt(
                        np.finfo(float).eps)):
                u2 = torch.cat([_lift(V, s2 / np.linalg.norm(s2)),
                                torch.zeros(1, dtype=_C, device=device)])
            else:
                lam2 = complex(rng.random())
                u2 = torch.as_tensor(rng.random(nm + 1), dtype=_C,
                                     device=device)
            return lam, u, loop_counter, u2, lam2
        pk = compute_Mlincomb(target_nep, lam, u[:, None], _ONE, startder=1)
        linsolver = create_linsolver(linsolvercreator, target_nep, lam)
        vnew = lin_solve(linsolver, pk, tol=tol).to(_C)
        newton_step = vnew.clone()
        V_mem[:, k] = _orth(V, vnew, orthmethod)
        W_mem[:, k] = _orth(W, rk, orthmethod)

    msg = _exceeded(maxit, conveig, neigs)
    if dnep is not None:
        D, X = np.linalg.eig(dnep.S0)
        u_vec = dnep.V0_t @ torch.as_tensor(X, device=device)
        raise NoConvergenceException(np.concatenate([D, [lam]]),
                                     torch.cat([u_vec, u[:n, None]], dim=1),
                                     err, msg)
    raise NoConvergenceException(lam, u, err, msg)
