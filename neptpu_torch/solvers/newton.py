"""Newton-type solvers: ``newton``, ``augnewton``, ``resinv``,
``quasinewton``, ``newtonqr``, ``implicitdet`` — all written against the
three-function protocol; linear solves go through the creator/cache layer so
factorizations amortize over the iterations.

The eigenvalue iterate is a host scalar, the vector iterate a tensor on the
solver's device (``device=None``: the card).  Each returns ``(lam, v)``
(``newtonqr``: ``(lam, v, w)``) with ``lam`` a Python scalar of ``dtype``'s
kind.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mder, compute_Mlincomb
from ..ops.linsolve import create_linsolver, lin_solve
from .common import (NoConvergenceException, armijo_rule, closest_to,
                     default_tol, init_vec, scalar_as, setup_solver,
                     solver_device, vec_as)
from .rf import compute_rf

__all__ = ["newton", "augnewton", "resinv", "quasinewton", "newtonqr",
           "implicitdet"]

_ONE = np.ones(1)


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def _start(nep, dtype, errmeasure, logger, tol, v, device):
    """The common preamble: (device, dtype, errmeasure, logger, tol, n, v)."""
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    tol = default_tol(dtype) if tol is None else tol
    return device, dtype, em, lg, tol, nep.n, init_vec(v, nep.n, dtype,
                                                       device=device)


def _as_vec(c, dtype, device):
    return vec_as(torch.as_tensor(c, device=device), dtype)


def _exceeded(lam, v, err, maxit):
    return NoConvergenceException(
        lam, v, err, f"Number of iterations exceeded. maxit={maxit}.")


def _scalar(x, dtype):
    """A 0-dim tensor as a host scalar of ``dtype``'s kind."""
    return scalar_as(complex(x), dtype)


def newton(nep, dtype=None, errmeasure=None, tol=None, maxit=10, lam=0.0,
           v=None, c=None, logger=0, armijo_factor=1.0, armijo_max=5,
           device=None):
    """Newton-Raphson on ``[M(lam) v; c^H v - 1] = 0`` with the bordered
    dense Jacobian."""
    device, dtype, em, lg, tol, n, v = _start(nep, dtype, errmeasure, logger,
                                              tol, v, device)
    c = v if c is None else _as_vec(c, dtype, device)
    lam = scalar_as(lam, dtype)
    v = v / torch.vdot(c, v)
    err = np.inf
    for k in range(maxit):
        err = estimate_error(em, lam, v)
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return lam, v
        M = _dense(compute_Mder(nep, lam))
        Md = _dense(compute_Mder(nep, lam, 1))
        jdt = torch.promote_types(M.dtype, dtype)
        J = torch.zeros((n + 1, n + 1), dtype=jdt, device=device)
        J[:n, :n] = M
        J[:n, n] = Md.to(jdt) @ v.to(jdt)
        J[n, :n] = torch.conj(c)
        F = torch.cat([M.to(jdt) @ v.to(jdt),
                       (torch.vdot(c, v) - 1).reshape(1).to(jdt)])
        delta = -torch.linalg.solve(J, F)
        dv = vec_as(delta[:n], dtype)
        dlam = _scalar(delta[n], dtype)
        dlam, dv, j, scaling = armijo_rule(nep, em, err, lam, v, dlam, dv,
                                           armijo_factor, armijo_max)
        v = v + dv
        lam = lam + dlam
    raise _exceeded(lam, v, err, maxit)


def augnewton(nep, dtype=None, errmeasure=None, tol=None, maxit=30, lam=0.0,
              v=None, c=None, logger=0, linsolvercreator=None,
              armijo_factor=1.0, armijo_max=5, device=None):
    """Newton iteration using only length-n operations: one lin_solve per
    iteration."""
    device, dtype, em, lg, tol, n, v = _start(nep, dtype, errmeasure, logger,
                                              tol, v, device)
    use_v_norm = c is not None and float(np.linalg.norm(
        _as_vec(c, dtype, "cpu").numpy())) == 0.0
    c = v if c is None else _as_vec(c, dtype, device)
    if use_v_norm:
        c = v / torch.linalg.vector_norm(v) ** 2
    lam = scalar_as(lam, dtype)
    v = v / torch.vdot(c, v)
    err = np.inf
    for k in range(maxit):
        err = estimate_error(em, lam, v)
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return lam, v
        z = compute_Mlincomb(nep, lam, v[:, None], _ONE, startder=1)
        linsolver = create_linsolver(linsolvercreator, nep, lam)
        tempvec = vec_as(lin_solve(linsolver, z, tol=tol), dtype)
        if use_v_norm:
            c = v / torch.linalg.vector_norm(v) ** 2
        alpha = 1.0 / torch.vdot(c, tempvec)
        dlam = _scalar(-alpha, dtype)
        dv = alpha * tempvec - v
        dlam, dv, j, _ = armijo_rule(nep, em, err, lam, v, dlam, dv,
                                     armijo_factor, armijo_max)
        lam = lam + dlam
        v = v + dv
    raise _exceeded(lam, v, err, maxit)


def resinv(nep, dtype=None, errmeasure=None, tol=None, maxit=100, lam=0.0,
           v=None, c=None, logger=0, inner_solver=None, linsolvercreator=None,
           armijo_factor=1.0, armijo_max=5, device=None):
    """Residual inverse iteration (Neumaier 1985): ONE factorization at the
    fixed shift reused every iteration + Rayleigh-functional eigenvalue
    updates."""
    device, dtype, em, lg, tol, n, v = _start(nep, dtype, errmeasure, logger,
                                              tol, v, device)
    use_v_as_rf = c is not None and float(np.linalg.norm(
        _as_vec(c, dtype, "cpu").numpy())) == 0.0
    c = v if c is None else _as_vec(c, dtype, device)
    lam = complex(lam)
    lg.info("Precomputing linsolver")
    linsolver = create_linsolver(linsolvercreator, nep, scalar_as(lam, dtype))
    err = np.inf
    for k in range(maxit):
        v = v / torch.linalg.vector_norm(v)
        err = estimate_error(em, lam, v)
        if use_v_as_rf:
            c = v
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return scalar_as(lam, dtype), v
        lam_vec = compute_rf(dtype, nep, v, inner_solver, y=c, lam=lam,
                             target=lam)
        lam1 = scalar_as(closest_to(lam_vec, lam), dtype)
        dlam = lam1 - lam
        dv = vec_as(-lin_solve(linsolver, compute_Mlincomb(
            nep, lam1, v[:, None], _ONE)), dtype)
        dlam, dv, j, _ = armijo_rule(nep, em, err, lam, v, dlam, dv,
                                     armijo_factor, armijo_max)
        lam = lam + dlam
        v = v + dv
    raise _exceeded(lam, v, err, maxit)


def quasinewton(nep, dtype=None, errmeasure=None, tol=None, maxit=100,
                lam=0.0, v=None, ws=None, logger=0, linsolvercreator=None,
                armijo_factor=1.0, armijo_max=5, device=None):
    """Quasi-Newton-2 (Jarlebring/Koskela/Mele 2018): fixed M(lam0)
    factorization."""
    device, dtype, em, lg, tol, n, v = _start(nep, dtype, errmeasure, logger,
                                              tol, v, device)
    ws = v if ws is None else _as_vec(ws, dtype, device)
    lam = scalar_as(lam, dtype)
    lg.info("Precomputing linsolver")
    linsolver = create_linsolver(linsolvercreator, nep, lam)
    err = np.inf
    for k in range(maxit):
        err = estimate_error(em, lam, v)
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return lam, v
        u = compute_Mlincomb(nep, lam, v[:, None], _ONE)
        w = compute_Mlincomb(nep, lam, v[:, None], _ONE, startder=1)
        dlam_t = -torch.vdot(ws.to(u.dtype), u) / torch.vdot(ws.to(w.dtype),
                                                              w)
        z = dlam_t * w + u
        dlam = _scalar(dlam_t, dtype)
        dv = -vec_as(lin_solve(linsolver, z, tol=tol), dtype)
        dlam, dv, j, _ = armijo_rule(nep, em, err, lam, v, dlam, dv,
                                     armijo_factor, armijo_max)
        lam = lam + dlam
        v = v + dv
    raise _exceeded(lam, v, err, maxit)


def newtonqr(nep, dtype=None, errmeasure=None, tol=None, maxit=100, lam=0.0,
             v=None, c=None, logger=0, device=None):
    """Kublanovskaya Newton-QR on a column-pivoted QR of M(lam), taken on
    the host by scipy (torch has no pivoted QR).  Returns ``(lam, v, w)``
    with ``w`` the left eigenvector approximation."""
    import scipy.linalg as sla

    device, dtype, em, lg, tol, n, v = _start(nep, dtype, errmeasure, logger,
                                              tol, v, device)
    lam = scalar_as(lam, dtype)
    err = np.inf
    w = None
    for k in range(maxit):
        A = _dense(compute_Mder(nep, lam)).cpu().numpy().astype(complex)
        Q, R, piv = sla.qr(A, pivoting=True)
        p = np.linalg.solve(R[: n - 1, : n - 1], R[: n - 1, n - 1])
        vfull = np.zeros(n, dtype=complex)
        vfull[piv] = np.concatenate([-p, [1.0]])
        v = _as_vec(vfull, dtype, device)
        w = _as_vec(Q[:, n - 1], dtype, device)
        err = estimate_error(em, lam, v)
        lg.iteration(k, errs=err, lams=lam)
        if float(err) < tol:
            return lam, v, w
        z = compute_Mlincomb(nep, lam, v[:, None], _ONE, startder=1)
        qn = torch.as_tensor(Q[:, n - 1], device=device)  # complex128
        d = complex(torch.vdot(qn, z.to(qn.dtype)))
        lam = lam - scalar_as(R[n - 1, n - 1] / d, dtype)
    raise _exceeded(lam, v, err, maxit)


def implicitdet(nep, dtype=None, errmeasure=None, tol=None, maxit=100,
                lam=0.0, v=None, c=None, logger=0, device=None):
    """Implicit determinant method (Spence & Poulton 2005): Newton on
    det(M(lam))/det(G(lam)) via a bordered LU each iteration."""
    device, dtype, em, lg, tol, n, v0 = _start(nep, dtype, errmeasure, logger,
                                               tol, v, device)
    c = v0 if c is None else _as_vec(c, dtype, device)
    b = c
    lam = scalar_as(lam, dtype)
    v = torch.cat([v0, torch.ones(1, dtype=dtype, device=device)])
    err = np.inf
    rhs1 = torch.zeros(n + 1, dtype=dtype, device=device)
    rhs1[n] = 1.0
    for k in range(maxit):
        A = vec_as(_dense(compute_Mder(nep, lam)), dtype)
        G = torch.zeros((n + 1, n + 1), dtype=dtype, device=device)
        G[:n, :n] = A
        G[:n, n] = b
        G[n, :n] = torch.conj(c)
        lu, piv = torch.linalg.lu_factor(G)
        v = torch.linalg.lu_solve(lu, piv, rhs1[:, None])[:, 0]
        Mdv = vec_as(_dense(compute_Mder(nep, lam, 1)), dtype) @ v[:n]
        rhs2 = torch.cat([-Mdv, torch.zeros(1, dtype=dtype, device=device)])
        vp = torch.linalg.lu_solve(lu, piv, rhs2[:, None])[:, 0]
        err = float(torch.abs(v[n]) / torch.linalg.matrix_norm(A))
        lg.iteration(k, errs=err, lams=lam)
        if err < tol:
            return lam, v[:n]
        lam = lam - _scalar(v[n] / vp[n], dtype)
    raise _exceeded(lam, v[:n], err, maxit)
