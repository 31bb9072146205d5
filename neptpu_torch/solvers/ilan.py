"""Infinite Lanczos for symmetric NEPs, written against the compute
protocol: the indefinite-scalar-product three-term recurrence, the
structured B-multiplication with the symmetrizer coefficients G and the
FDH derivative tables, and extraction by projection (``proj_solve=True``,
the default) or from the tridiagonal H.

The recurrence blocks ``Q, Qp, Qn (n, m+1)``, the basis ``V`` and every
term apply live on the solver's device; the small tables (G, FDH, the SVD
of G) and H are host numpy.  On a delay problem ``Bmult`` takes the rank-q
fast path: ``G .* FDH`` is ``c diag(w) G diag(w)`` per delay term, so each
term is applied to q columns only (q the numerical rank of G); a term of a
DIA bank goes through the bank's kernel, one pair launch per column.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb
from ..ops.linsolve import create_linsolver, lin_solve
from ..ops.orth import DGKS, orthogonalize_and_normalize
from .common import (NoConvergenceException, init_vec, scalar_as,
                     setup_solver, solver_device)
from .iar import _progress

__all__ = ["ilan", "symmetrizer_coefficients"]


def symmetrizer_coefficients(m):
    """The symmetrizer coefficients ``G (m+1, m+1)``."""
    G = np.zeros((m + 1, m + 1))
    for i in range(m + 1):
        G[i, 0] = 1.0 / (i + 1)
    for j in range(m):
        for i in range(m + 1):
            G[i, j + 1] = G[i, j] * (j + 1) / (i + j + 2)
    return G


def _fdh_tables(nep, m, sigma, gamma):
    """``FDH[t][i, j] = f_t^{(i+j+1)}(sigma) gamma^{i+j+1}`` from the scaled
    bidiagonal trick (complex128, host)."""
    SS = complex(sigma) * np.eye(2 * m + 2, dtype=complex) + np.diag(
        complex(gamma) * np.arange(1, 2 * m + 2), -1)
    FDH = []
    for f in nep.get_fv():
        fD = f(torch.from_numpy(SS)).numpy()[:, 0]
        T = np.empty((m + 1, m + 1), dtype=complex)
        for i in range(m + 1):
            T[i, :] = fD[i + 1: i + m + 2]
        FDH.append(T)
    return FDH


def term_matmat(nep, t, X):
    """``Av[t] @ X`` for the problem's SPMF term ``t`` (``get_Av`` order; a
    delay problem's ``-lam I`` term is ``t = 0``).  A term of a bank that
    takes a term-major operand (the DIA bank) is applied through the bank's
    fused apply with that term's weight row alone, one column at a time: on
    the card one pair launch of the DIA kernel per complex column, at the
    bank's own shape."""
    bank = getattr(nep, "bank", None)
    ti = t - 1 if hasattr(nep, "tauv") else t
    if hasattr(nep, "tauv") and t == 0:
        return X.clone()
    if bank is None or not hasattr(bank, "lincomb_apply_t"):
        return nep.get_Av()[t] @ X
    WT = torch.zeros((bank.nterms, X.shape[0]), dtype=X.dtype,
                     device=X.device)
    cols = []
    for c in range(X.shape[1]):
        WT[ti] = X[:, c]
        cols.append(bank.lincomb_apply_t(WT))
    return torch.stack(cols, dim=1)


def _bmult(nep, k, Qn, G, FDH, sigma, gamma):
    """``Z = sum_t Av[t] Qn (G .* FDH[t])`` over the first k+1 columns.

    Delay problem (``tauv``): for ``f = exp(-tau lam)``, ``FDH[i, j] = c w_i
    w_j`` with ``w_i = (gamma (-tau))^i``, ``c = gamma (-tau) e^{-sigma
    tau}`` - rank one - so ``G .* FDH = c diag(w) G diag(w)``; G compressed
    by SVD to rank q (1e-12) makes each term's apply ``Z_t = c A_t [Qn (w .*
    U)] (w .* V)^T`` on q columns.  The identity term ``-lam I``
    contributes ``-gamma Qn[:, 0]`` to column 0 only."""
    n, dev, cdt = Qn.shape[0], Qn.device, Qn.dtype

    def t_(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=cdt,
                               device=dev)

    Z = torch.zeros((n, k + 1), dtype=cdt, device=dev)
    if hasattr(nep, "tauv"):
        U, S, Vt = np.linalg.svd(G[: k + 1, : k + 1])
        q = int(np.sum(S > 1e-12))
        Us = U[:, :q] * np.sqrt(S[:q])
        Vs = Vt[:q].T * np.sqrt(S[:q])
        Z[:, 0] = -gamma * Qn[:, 0]
        for t, tau in enumerate(np.asarray(nep.tauv, dtype=float)):
            w = (gamma * (-tau)) ** np.arange(k + 1)
            c = gamma * (-tau) * np.exp(-sigma * tau)
            QQ = Qn[:, : k + 1] @ t_(Us * w[:, None])  # (n, q)
            R = t_((Vs * w[:, None]).T)
            if q <= k + 1:
                Z += c * (term_matmat(nep, t + 1, QQ) @ R)
            else:
                Z += c * term_matmat(nep, t + 1, QQ @ R)
        return Z
    for t in range(len(FDH)):
        Wt = Qn[:, : k + 1] @ t_(G[: k + 1, : k + 1] * FDH[t][: k + 1, : k + 1])
        Z += term_matmat(nep, t, Wt)
    return Z


def ilan(nep, dtype=None, orthmethod=None, maxit=30, linsolvercreator=None,
         tol=None, neigs=6, errmeasure=None, sigma=0.0, gamma=1.0, v=None,
         logger=0, check_error_every=30, inner_solver_method=None,
         proj_solve=True, inner_logger=0, device=None):
    """Infinite Lanczos.  Returns ``(lam, W, err_hist, V)``: the converged
    eigenvalues (numpy), their eigenvectors and the orthonormalised basis
    (tensors on the device), and the error history; raises
    :class:`NoConvergenceException` with the partial results when fewer
    than ``neigs`` converge in ``maxit`` steps.  ``proj_solve=True``
    extracts from the projection of the problem onto the basis (inner
    solver ``inner_solver_method``, on the host), else from H.
    ``device=None`` is the card."""
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

    def zeros():
        return torch.zeros((n, m + 1), dtype=cdt, device=device)

    V, Q, Qp, Qn, W, QQ = (zeros() for _ in range(6))
    H = np.zeros((m + 1, m), dtype=complex)
    HH = np.zeros((m + 1, m), dtype=complex)
    omega = np.zeros(m + 1, dtype=complex)
    a = np.array([gamma ** i for i in range(2 * m + 3)], dtype=complex)
    a[0] = 0.0
    M0inv = create_linsolver(linsolvercreator, nep, scalar_as(sigma, dtype))
    err_hist = np.full((m, m + 1), np.nan)
    FDH = _fdh_tables(nep, m, sigma, gamma)
    G = symmetrizer_coefficients(m)
    inv_j = torch.as_tensor(1.0 / np.arange(1, m + 1), dtype=cdt,
                            device=device)

    v0 = init_vec(v, n, dtype, device=device).to(cdt)
    Q[:, 0] = v0 / torch.linalg.vector_norm(v0)
    omega[0] = complex(torch.sum(Q[:, 0] * compute_Mlincomb(
        nep, 0.0, torch.stack([Q[:, 0], Q[:, 0]], dim=1),
        np.array([0.0, 1.0]))))
    V[:, 0] = Q[:, 0]

    lam = np.zeros(0, dtype=complex)
    k = 1
    conv_eig = 0
    while k <= m and conv_eig < neigs:
        Qn[:, 1: k + 1] = Q[:, :k] * inv_j[:k]
        z = compute_Mlincomb(nep, sigma, Qn[:, : k + 1], a[: k + 1])
        Qn[:, 0] = -lin_solve(M0inv, z).to(cdt)

        Z = _bmult(nep, k, Qn, G, FDH, sigma, gamma)

        beta = complex(torch.sum(Z[:, :k] * Qp[:, :k])) if k > 1 else 0.0
        alpha = complex(torch.sum(Z[:, :k] * Q[:, :k]))
        eta = complex(torch.sum(Z[:, : k + 1] * Qn[:, : k + 1]))

        H[k - 1, k - 1] = alpha / omega[k - 1]
        if k > 1:
            H[k - 2, k - 1] = beta / omega[k - 2]
        Qn[:, :k] -= complex(H[k - 1, k - 1]) * Q[:, :k]
        if k > 1:
            Qn[:, :k] -= complex(H[k - 2, k - 1]) * Qp[:, :k]
        H[k, k - 1] = float(torch.linalg.vector_norm(Qn))
        Qn[:, : k + 1] /= complex(H[k, k - 1])
        omega[k] = (eta - 2 * alpha * H[k - 1, k - 1]
                    + omega[k - 1] * H[k - 1, k - 1] ** 2)
        if k > 1:
            omega[k] += (-2 * beta * H[k - 2, k - 1]
                         + omega[k - 2] * H[k - 2, k - 1] ** 2)
        omega[k] /= H[k, k - 1] ** 2
        V[:, k] = Qn[:, 0]
        wout, hh, _ = orthogonalize_and_normalize(V[:, :k], V[:, k],
                                                  orthmethod)
        HH[:k, k - 1] = hh.cpu().numpy()
        V[:, k] = wout
        QQ[:, k - 1] = Q[:, 0]

        if (k % check_error_every == 0) or k == m:
            if not proj_solve:
                D, W_ritz = np.linalg.eig(H[:k, :k])
                W[:, :k] = QQ[:, :k] @ torch.as_tensor(W_ritz, dtype=cdt,
                                                       device=device)
                lam = sigma + gamma / D
            else:
                from ..models.projection import create_proj_NEP
                from .inner import inner_solve

                VV = V[:, : k + 1]
                pnep = create_proj_NEP(nep, VV.shape[1])
                pnep.set_projectmatrices(VV, VV)
                lamproj, Wproj = inner_solve(
                    inner_solver_method, dtype, pnep, neigs=m, tol=tol,
                    inner_logger=inner_logger)
                lamproj = np.atleast_1d(np.asarray(lamproj))
                q = min(len(lamproj), m)
                lam = lamproj[:q]
                W[:, :q] = VV @ torch.as_tensor(
                    np.asarray(Wproj)[:, :q], dtype=cdt, device=device)
            errs = np.array([float(estimate_error(em, lam[s], W[:, s]))
                             for s in range(len(lam))])
            err_hist[k - 1, : len(lam)] = errs
            _progress(lg, k, errs, lam, tol)
            conv_eig = int(np.sum(errs < tol))
            if k == m or conv_eig >= neigs:
                idx = np.argsort(errs)[: int(min(conv_eig, neigs))]
                lam = lam[idx]
                W = W[:, torch.as_tensor(idx, device=device)]
        k += 1
        Qp, Q, Qn = Q, Qn, Qp
        Qn.zero_()

    k -= 1
    if conv_eig < neigs and neigs != np.inf:
        raise NoConvergenceException(
            lam, W, err_hist, f"Number of iterations exceeded. maxit={maxit}.")
    return lam, W[:, : len(lam)], err_hist, V[:, : k + 1]
