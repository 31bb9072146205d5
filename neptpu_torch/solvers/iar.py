"""Infinite Arnoldi (Taylor basis), written against the compute protocol.

Per iteration:
  1. derivative shift-scale of the last basis vector's blocks (vector ops)
  2. ONE structured Mlincomb (the fused multi-term apply of the term bank)
  3. ONE lin_solve against the cached M(sigma) factorization
  4. tall-skinny Gram-Schmidt on the growing n(k+1) basis

The basis ``V (n(m+1), m+1)`` and the work block ``y`` are tensors on the
solver's device for the whole run; only the projection coefficients (a
column of the small Hessenberg ``H``) come to the host, where the Ritz values
``lam = sigma + gamma / eig(H)`` are extracted.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb
from ..models.projection import create_proj_NEP
from ..ops.linsolve import create_linsolver, lin_solve
from ..ops.orth import DGKS, orthogonalize_and_normalize
from .common import (NoConvergenceException, init_vec, scalar_as,
                     setup_solver, solver_device)
from .inner import inner_solve

__all__ = ["iar"]


def _progress(lg, k, errs, lams, tol):
    lg.iteration(k, errs=errs, lams=lams, level=2)
    lg.info("".join("+" if e < tol else "=" if e < tol * 10 else "-"
                    for e in errs))


def iar(nep, dtype=None, orthmethod=None, maxit=30, linsolvercreator=None,
        tol=None, neigs=6, errmeasure=None, sigma=0.0, gamma=1.0, v=None,
        logger=0, check_error_every=1, proj_solve=False,
        inner_solver_method=None, inner_logger=0, device=None):
    """Returns ``(lams, Q, V)``: the converged eigenvalues (numpy), their
    eigenvectors and the Krylov basis (tensors on the device).  Raises
    :class:`NoConvergenceException` carrying the partial results when fewer
    than ``neigs`` pairs converge in ``maxit`` steps."""
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = 10000 * float(torch.finfo(real_of(dtype)).eps)
    if orthmethod is None:
        orthmethod = DGKS()
    n = nep.n
    m = maxit
    sigma = complex(sigma)
    gamma = complex(gamma)
    cdt = torch.complex128

    V = torch.zeros((n * (m + 1), m + 1), dtype=cdt, device=device)
    H = np.zeros((m + 1, m), dtype=complex)
    alpha = np.array([gamma**i for i in range(m + 1)], dtype=complex)
    alpha[0] = 0.0
    inv_j = torch.as_tensor(1.0 / np.arange(1, m + 1), dtype=cdt,
                            device=device)

    M0inv = create_linsolver(linsolvercreator, nep, scalar_as(sigma, dtype))

    err_hist = np.full((m, m + 1), np.nan)
    lams = np.zeros(0, dtype=complex)
    Q = torch.zeros((n, 0), dtype=cdt, device=device)

    v0 = init_vec(v, n, dtype, device=device).to(cdt)
    V[:n, 0] = v0 / torch.linalg.vector_norm(v0)

    pnep = create_proj_NEP(nep) if proj_solve else None

    k = 1
    conv_eig = 0
    while k <= m and conv_eig < neigs:
        # y[:, 1:k+1] = the previous basis vector's blocks, scaled by 1/(1:k)
        y = torch.zeros((n, k + 1), dtype=cdt, device=device)
        y[:, 1:] = V[: n * k, k - 1].reshape(k, n).T * inv_j[:k]
        # y[:, 0] = -M(sigma)^{-1} * Mlincomb(y, alpha)
        z = compute_Mlincomb(nep, sigma, y, alpha[: k + 1])
        y[:, 0] = -lin_solve(M0inv, z).to(cdt)
        vv = y.T.reshape(-1)  # stacked blocks, length n (k+1)
        w, h, beta = orthogonalize_and_normalize(
            V[: n * (k + 1), :k], vv, orthmethod)
        H[:k, k - 1] = h.cpu().numpy()
        H[k, k - 1] = complex(beta)
        V[: n * (k + 1), k] = w

        if (k % check_error_every == 0) or k == m:
            D, Z = np.linalg.eig(H[:k, :k])
            Q = V[:n, :k] @ torch.as_tensor(Z, dtype=cdt, device=device)
            lams = sigma + gamma / D
            if proj_solve:
                # the Ritz values refined on the projection onto the first
                # block of the basis
                QQ, RR = torch.linalg.qr(V[:n, :k])
                pnep.set_projectmatrices(QQ, QQ)
                lproj, Qproj = inner_solve(
                    inner_solver_method, dtype, pnep,
                    V=RR.cpu().numpy() @ Z, lamv=lams.copy(), neigs=k,
                    sigma=np.mean(lams), inner_logger=inner_logger, tol=tol)
                Q = QQ @ torch.as_tensor(Qproj, dtype=cdt, device=device)
                lams = np.asarray(lproj)
            errs = np.array([float(estimate_error(em, lams[s], Q[:, s]))
                             for s in range(len(lams))])
            err_hist[k - 1, : len(lams)] = errs
            _progress(lg, k, errs, lams, tol)
            conv_eig = int(np.sum(errs < tol))
            if k == m or conv_eig >= neigs:
                idx = np.argsort(errs)[: int(min(len(lams), neigs))]
                lams = lams[idx]
                Q = Q[:, torch.as_tensor(idx, device=device)]
        k += 1
    k -= 1

    if conv_eig < neigs and neigs != np.inf:
        msg = f"Number of iterations exceeded. maxit={maxit}."
        if conv_eig < 3:
            msg += (" Try to change the inner_solver_method for better "
                    "performance.")
        raise NoConvergenceException(lams, Q, err_hist, msg)

    nc = int(min(len(lams), conv_eig))
    return lams[:nc], Q[:, :nc], V[:, :k]
