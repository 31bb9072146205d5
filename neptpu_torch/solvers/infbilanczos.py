"""Infinite bi-Lanczos (Gaaf and Jarlebring), written against the compute
protocol: two-sided three-term recurrences on left and right infinite
Krylov bases, tridiagonal Ritz extraction; needs the transposed problem.

The recurrence blocks (n, m+1) and every ``compute_Mlincomb`` live on the
solver's device; the tridiagonal ``T``, its eigenpairs and the recurrence
scalars are host numpy."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb
from ..ops.linsolve import create_linsolver, lin_solve
from .common import (NoConvergenceException, init_vec, setup_solver,
                     solver_device)
from .iar import _progress

__all__ = ["infbilanczos"]


def _lfact(j):
    return math.lgamma(j + 1)


def infbilanczos(nep, nept, dtype=None, maxit=30, linsolvercreator=None,
                 linsolvertcreator=None, v=None, u=None, tol=1e-12, neigs=5,
                 errmeasure=None, sigma=0.0, gamma=1.0, logger=0,
                 check_error_every=1, device=None):
    """Returns ``(lam, Q, T)``: the converged eigenvalues (numpy), unit
    eigenvectors (a tensor on the device) and the tridiagonal matrix
    (numpy); raises :class:`NoConvergenceException` with the partial
    results when fewer than ``neigs`` converge in ``maxit`` steps.  ``nept``
    is the transposed problem, on the same device.  ``device=None`` is the
    card."""
    device = solver_device(nep, device)
    solver_device(nept, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    n = nep.n
    sigma = complex(sigma)
    cdt = torch.complex128
    v = init_vec(v, n, dtype, seed=8, device=device).to(cdt)
    u = init_vec(u, n, dtype, seed=9, device=device).to(cdt)

    M0inv = create_linsolver(linsolvercreator, nep, sigma)
    M0Tinv = create_linsolver(linsolvertcreator, nept, sigma)

    m = maxit
    qt = lin_solve(M0Tinv, u).to(cdt)
    q = v / complex(qt.conj() @ compute_Mlincomb(
        nep, sigma, v[:, None], np.ones(1), startder=1))

    def mlin(nn, s, X, startder):
        return compute_Mlincomb(nn, s, X, np.ones(X.shape[1]),
                                startder=startder)

    fact = np.exp(-np.array([_lfact(i) for i in range(2 * m + 3)]))

    def left_right_scalar_prod(At, B, ma, mb):
        c = 0.0 + 0.0j
        for j in range(1, ma + 1):
            dd = torch.as_tensor(fact[j: j + mb], dtype=cdt, device=device)
            z = -mlin(nep, sigma, B[:, :mb] * dd[None, :], j)
            c += complex(At[:, j - 1].conj() @ z)
        return c

    def zeros(cols):
        return torch.zeros((n, cols), dtype=cdt, device=device)

    Q0, Qt0, Q1, Qt1 = zeros(m), zeros(m), zeros(m), zeros(m)
    R1, Rt1, R2, Rt2 = zeros(m + 1), zeros(m + 1), zeros(m + 1), zeros(m + 1)
    Q_basis = zeros(m + 1)
    R1[:, 0] = q
    Rt1[:, 0] = qt
    alpha = np.zeros(m + 1, dtype=complex)
    beta = np.zeros(m + 1, dtype=complex)
    gam = np.zeros(m + 1, dtype=complex)

    lam = np.zeros(0, dtype=complex)
    Q = zeros(0)
    err = np.zeros(0)
    for k in range(1, m + 1):
        omega = np.conj(left_right_scalar_prod(Rt1, R1, k, k))
        beta[k - 1] = np.sqrt(abs(omega))
        gam[k - 1] = np.conj(omega) / beta[k - 1]
        Q1[:, :k] = R1[:, :k] / complex(beta[k - 1])
        Qt1[:, :k] = Rt1[:, :k] / complex(np.conj(gam[k - 1]))
        Q_basis[:, k - 1] = Q1[:, 0]

        Dk = torch.as_tensor(fact[1: k + 1], dtype=cdt, device=device)
        b1 = -lin_solve(M0inv, mlin(nep, sigma, Q1[:, :k] * Dk, 1)).to(cdt)
        bt1 = -lin_solve(M0Tinv, mlin(nept, np.conj(sigma),
                                      Qt1[:, :k] * Dk, 1)).to(cdt)

        R2[:, 0] = b1
        R2[:, 1: k + 1] = Q1[:, :k]
        if k > 1:
            R2[:, : k - 1] -= complex(gam[k - 1]) * Q0[:, : k - 1]
        Rt2[:, 0] = bt1
        Rt2[:, 1: k + 1] = Qt1[:, :k]
        if k > 1:
            Rt2[:, : k - 1] -= complex(np.conj(beta[k - 1])) * Qt0[:, : k - 1]

        alpha[k] = left_right_scalar_prod(Qt1, R2, k, k + 1)
        R2[:, :k] -= complex(alpha[k]) * Q1[:, :k]
        Rt2[:, :k] -= complex(np.conj(alpha[k])) * Qt1[:, :k]

        R1, R2 = R2, R1
        R2.zero_()
        Rt1, Rt2 = Rt2, Rt1
        Rt2.zero_()
        Q0, Q1 = Q1, Q0
        Q1.zero_()
        Qt0, Qt1 = Qt1, Qt0
        Qt1.zero_()

        if k % check_error_every == 0 or k == m:
            omega = left_right_scalar_prod(Rt1, R1, k + 1, k + 1)
            beta[k] = np.sqrt(abs(omega))
            gam[k] = np.conj(omega) / beta[k]
            alpha0, beta0, gamma0 = alpha[1: k + 1], beta[1: k + 1], \
                gam[1: k + 1]
            TT = (np.diag(alpha0[:k]) + np.diag(beta0[: k - 1], -1)
                  + np.diag(gamma0[: k - 1], 1))
            D, Z = np.linalg.eig(TT)
            lam = sigma + 1.0 / D
            Q = Q_basis[:, :k] @ torch.as_tensor(Z[:k, :], dtype=cdt,
                                                 device=device)
            errs = np.array([float(estimate_error(em, lam[s], Q[:, s]))
                             for s in range(len(lam))])
            conv_eig = int(np.sum(errs < tol))
            _progress(lg, k, errs, lam, tol)
            idx = np.argsort(errs)
            err = errs[idx]
            if conv_eig >= neigs or k == m:
                nrof = int(min(len(lam), neigs, max(conv_eig, 1)))
                lam = lam[idx[:nrof]]
                Q = Q[:, torch.as_tensor(idx[:nrof], device=device)]
                Q = Q / torch.linalg.vector_norm(Q, dim=0, keepdim=True)
                if conv_eig >= neigs or neigs == np.inf:
                    return lam, Q, TT
    raise NoConvergenceException(
        lam, Q, err, f"Number of iterations exceeded. maxit={maxit}.")
