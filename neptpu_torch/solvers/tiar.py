"""Tensor infinite Arnoldi, written against the compute protocol.

Same math as IAR but the growing basis is factorized as ``Z (n x k)`` times a
coefficient tensor ``a (m+1)^3``: memory O(nm + m^3) instead of O(nm^2).  The
per-iteration length-n work (``Z[:, :k] @ a``-slice, the Mlincomb, the
lin_solve, the Gram-Schmidt against ``Z``) runs on the solver's device, where
``Z`` lives for the whole run; the O(m^3) tensor bookkeeping is scalar work
kept on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.exceptions import LostOrthogonalityException
from ..core.nep import compute_Mlincomb
from ..models.projection import create_proj_NEP
from ..ops.linsolve import create_linsolver, lin_solve
from ..ops.orth import DGKS, orthogonalize_and_normalize
from .common import (NoConvergenceException, init_vec, scalar_as,
                     setup_solver, solver_device)
from .iar import _progress
from .inner import inner_solve

__all__ = ["tiar"]


def tiar(nep, dtype=None, orthmethod=None, maxit=30, linsolvercreator=None,
         tol=None, neigs=6, errmeasure=None, sigma=0.0, gamma=1.0, v=None,
         logger=0, check_error_every=1, proj_solve=False,
         inner_solver_method=None, inner_logger=0, device=None):
    """Returns ``(lams, Q, Z)``: the converged eigenvalues (numpy), their
    eigenvectors and the orthonormal factor of the basis (tensors on the
    device).  Raises :class:`NoConvergenceException` carrying the partial
    results when fewer than ``neigs`` pairs converge in ``maxit`` steps."""
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = 10000 * float(torch.finfo(real_of(dtype)).eps)
    if orthmethod is None:
        orthmethod = DGKS()
    n = nep.n
    m = maxit
    if n < m:
        raise LostOrthogonalityException(
            "Loss of orthogonality in the matrix Z. The problem size is too "
            "small, use iar instead.")
    sigma = complex(sigma)
    gamma = complex(gamma)
    cdt = torch.complex128

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=cdt,
                               device=device)

    a = np.zeros((m + 1, m + 1, m + 1), dtype=complex)
    Z = torch.zeros((n, m + 1), dtype=cdt, device=device)
    t = np.zeros(m + 1, dtype=complex)
    H = np.zeros((m + 1, m), dtype=complex)
    alpha = np.array([gamma**i for i in range(m + 1)], dtype=complex)
    alpha[0] = 0.0
    M0inv = create_linsolver(linsolvercreator, nep, scalar_as(sigma, dtype))
    err_hist = np.full((m + 1, m + 1), np.nan)
    lams = np.zeros(0, dtype=complex)
    Q = torch.zeros((n, 0), dtype=cdt, device=device)

    v0 = init_vec(v, n, dtype, device=device).to(cdt)
    Z[:, 0] = v0 / torch.linalg.vector_norm(v0)
    a[0, 0, 0] = 1.0

    k = 1
    conv_eig = 0
    while k <= m and conv_eig < neigs:
        # y[:, 1:k+1] = Z[:, :k] @ a[:k, k-1, :k]^T, columns scaled by 1/(1:k)
        y = torch.zeros((n, k + 1), dtype=cdt, device=device)
        y[:, 1:] = Z[:, :k] @ dev(a[:k, k - 1, :k].T / np.arange(1, k + 1))
        z = compute_Mlincomb(nep, sigma, y, alpha[: k + 1])
        y0 = -lin_solve(M0inv, z).to(cdt)

        # Gram-Schmidt of y0 against Z
        w, tk, beta = orthogonalize_and_normalize(Z[:, :k], y0, orthmethod)
        t[:k] = tk.cpu().numpy()
        t[k] = complex(beta)
        Z[:, k] = w

        # tensor-level orthogonalization: two passes of classical
        # Gram-Schmidt of g against the slices a[:, j, :], j < k
        g = np.zeros((m + 1, m + 1), dtype=complex)
        for l in range(k + 1):
            g[1 : k + 1, l] = a[:k, k - 1, l] / np.arange(1, k + 1)
            g[0, l] = t[l]
        h = np.zeros(m + 1, dtype=complex)
        for l in range(k):
            h[:k] += a[:k, :k, l].conj().T @ g[:k, l]
        f = g.copy()
        for l in range(k):
            f[: k + 1, l] -= a[: k + 1, :k, l] @ h[:k]
        hh = np.zeros(m + 1, dtype=complex)
        for l in range(k):
            hh[:k] += a[:k, :k, l].conj().T @ f[:k, l]
        ff = f.copy()
        for l in range(k):
            ff[: k + 1, l] -= a[: k + 1, :k, l] @ hh[:k]
        h = h + hh
        f = ff
        beta2 = np.linalg.norm(f[: k + 1, : k + 1])

        H[:k, k - 1] = h[:k]
        H[k, k - 1] = beta2
        a[: k + 1, k, : k + 1] = f[: k + 1, : k + 1] / beta2

        if (k % check_error_every == 0) or k == m:
            D, W = np.linalg.eig(H[:k, :k])
            Q = Z[:, :k] @ dev(a[0, :k, :k].T @ W)
            lams = sigma + gamma / D
            if proj_solve:
                # the Ritz values refined on the projection onto Z
                pnep = create_proj_NEP(nep)
                pnep.set_projectmatrices(Z[:, :k], Z[:, :k])
                lproj, Qproj = inner_solve(
                    inner_solver_method, dtype, pnep, lamv=lams.copy(),
                    neigs=len(lams) + 3, sigma=sigma, tol=tol / 10,
                    inner_logger=inner_logger)
                II = np.argsort(np.abs(lproj - sigma))
                lams = lproj[II]
                Q = Z[:, :k] @ dev(Qproj[:, II])
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
            msg += " Check that sigma is not an eigenvalue."
        raise NoConvergenceException(lams, Q, err_hist, msg)
    nc = int(min(len(lams), conv_eig))
    return lams[:nc], Q[:, :nc], Z[:, :k]
