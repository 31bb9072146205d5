"""Infinite Arnoldi in the Chebyshev basis on [a, b], written against the
compute protocol.  ``compute_y0`` per problem class:

* DEP:  ``T_i(-kk tau + cc)`` tables (robust for delay problems, the default);
* PEP:  the derivation-matrix recurrence;
* SPMF: divided-difference matrix functions ``f[S, sigma]`` by the 2 x 2
  block trick;
* generic: Chebyshev <-> monomial conversion around one Taylor-IAR step
  (may be unstable at high degree);
* a callable, the extension point for problem classes with their own
  recurrence.

The basis ``V (n(m+1), m+1)`` and every n-sized block live on the solver's
device; a step's term applies are one fused bank apply (on the card one
pair launch of the DIA kernel for a banded problem).  The Chebyshev tables,
the Hessenberg ``H`` and the Ritz extraction are host numpy.
"""
from __future__ import annotations

import inspect
import warnings

import numpy as np
import torch

from ..config import real_of
from ..core.errmeasure import estimate_error
from ..core.nep import compute_Mlincomb, compute_resnorm
from ..models.dep import DEP
from ..models.pep import PEP
from ..models.spmf import SPMF_NEP, _bank_lincomb
from ..ops.linsolve import create_linsolver, lin_solve
from ..ops.orth import DGKS, orthogonalize_and_normalize
from .common import (NoConvergenceException, init_vec, scalar_as,
                     setup_solver, solver_device)
from .iar import _progress

__all__ = ["iar_chebyshev"]


def _cheb_vals(x, m):
    """``[T_0(x), ..., T_m(x)]``, stable for |x| <= 1 and beyond."""
    II = np.arange(m + 1)
    if abs(x) <= 1:
        return np.cos(II * np.arccos(x))
    if x >= 1:
        return np.cosh(II * np.arccosh(x))
    return ((-1.0) ** II) * np.cosh(II * np.arccosh(-x))


def _L_matrix(m, a, b):
    L = np.diag(np.concatenate([[2.0], 1.0 / np.arange(2, m + 1)]))
    L += np.diag(-1.0 / np.arange(1, m - 1), -2)
    return L * (b - a) / 4


def _mon2cheb(rho, gamma_, avec):
    n = len(avec) - 1
    al = 1 / (2 * rho)
    be = -gamma_ / rho
    b = np.zeros(n + 3, dtype=complex)
    for j in range(n, -1, -1):
        bb = np.zeros(n + 3, dtype=complex)
        bb[0] = al * b[1] + be * b[0] + avec[j]
        bb[1] = be * b[1] + al * b[2] + 2 * al * b[0]
        for k in range(3, n - j):
            bb[k - 1] = al * b[k - 2] + be * b[k - 1] + al * b[k]
        if n - j > 2:
            bb[n - j - 1] = al * b[n - j - 2] + be * b[n - j - 1]
        if n - j + 1 > 2:
            bb[n - j] = al * b[n - j - 1]
        b = bb
    return b[: n + 1]


def _cheb2mon(rho, gamma_, cvec):
    n = len(cvec) - 1
    al = 1 / (2 * rho)
    be = -gamma_ / rho
    a = np.zeros(n + 3, dtype=complex)
    bb = np.zeros(n + 3, dtype=complex)
    bb[: n + 1] = cvec
    for j in range(1, n + 2):
        b = np.zeros(n + 3, dtype=complex)
        for k in range(n - j + 1, 1, -1):
            b[k - 1] = (bb[k] - be * b[k] - al * b[k + 1]) / al
        b[0] = (bb[1] - be * b[1] - al * b[2]) / (2 * al)
        a[j - 1] = bb[0] - al * b[1] - be * b[0]
        bb = b
    return a[: n + 1]


def _dd0_mat_fun(f, S, sigma):
    """The divided-difference matrix function ``f[S, sigma I]`` by the
    2 x 2 block trick (host, complex128)."""
    n = S.shape[0]
    A = np.zeros((2 * n, 2 * n), dtype=complex)
    A[:n, :n] = S
    A[:n, n:] = np.eye(n)
    A[n:, n:] = sigma * np.eye(n)
    return f(torch.from_numpy(A)).numpy()[:n, n:]


def _terms_apply(nep, X, D):
    """``sum_i Av[i] (X @ D[i])`` over the problem's SPMF terms
    ``Av = get_Av()`` for a weight table ``D (terms, k)``: one fused apply
    of the bank (the DIA kernel on the card), with a DEP's leading
    ``-lam I`` term (identity operand) added directly."""
    D = torch.as_tensor(D, dtype=X.dtype, device=X.device)
    if isinstance(nep, DEP):
        return X @ D[0] + _bank_lincomb(nep.bank, X, D[1:])
    bank = getattr(nep, "bank", None)
    if bank is not None and bank.nterms == D.shape[0]:
        return _bank_lincomb(bank, X, D)
    z = None
    for A, d in zip(nep.get_Av(), D):
        t = A @ (X @ d)
        z = t if z is None else z + t
    return z


def _accepts_shift(fn):
    """Whether a ``compute_y0`` callable takes ``sigma=`` and ``gamma=``."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return True
    return "sigma" in params and "gamma" in params


def iar_chebyshev(nep, dtype=None, orthmethod=None, maxit=30,
                  linsolvercreator=None, tol=None, neigs=6, errmeasure=None,
                  sigma=0.0, gamma=1.0, v=None, logger=0, check_error_every=1,
                  compute_y0_method=":Auto", a=None, b=None, device=None):
    """Chebyshev-basis infinite Arnoldi.  Returns ``(lams, Q)``: the
    converged eigenvalues (numpy) and eigenvectors (a tensor on the device),
    best first; raises :class:`NoConvergenceException` with the partial
    results when fewer than ``neigs`` converge in ``maxit`` steps.

    ``compute_y0_method``: ``":Auto"``/``":DEP"``/``":PEP"``/``":SPMF"``/
    ``":Generic"``, or a callable ``(nep, X, Y, k, M0inv, a, b) -> y0``
    taking the Chebyshev-coefficient block ``X (n, k)``, the candidate ``Y
    (n, k+1)`` (columns ``1..k`` are ``X @ L``), the degree, the shifted
    linear solver and the interval, and returning the new 0th coefficient
    (length n).  A callable whose signature also takes ``sigma`` and
    ``gamma`` gets them as keywords; one with the JAX package's signature is
    called exactly as there.  ``:DEP`` and ``:PEP`` at ``sigma != 0`` or
    ``gamma != 1`` shift and scale the problem explicitly first (with a
    warning) and measure errors as the original problem's residual.
    ``device=None`` is the card."""
    device = solver_device(nep, device)
    dtype, em, lg = setup_solver(nep, dtype, errmeasure, logger)
    if tol is None:
        tol = 10000 * float(torch.finfo(real_of(dtype)).eps)
    if orthmethod is None:
        orthmethod = DGKS()
    if a is None:
        a = -float(np.max(np.asarray(nep.tauv))) if isinstance(nep, DEP) \
            else -1.0
    if b is None:
        b = 0.0 if isinstance(nep, DEP) else 1.0
    if compute_y0_method == ":Auto":
        if isinstance(nep, DEP):
            compute_y0_method = ":DEP"
        elif isinstance(nep, PEP):
            compute_y0_method = ":PEP"
        elif isinstance(nep, SPMF_NEP):
            compute_y0_method = ":SPMF"
        else:
            compute_y0_method = ":Generic"
    sigma = complex(sigma)
    gamma = complex(gamma)
    sigma_orig = gamma_orig = None
    if (sigma != 0 or gamma != 1) and compute_y0_method in (":DEP", ":PEP"):
        from ..transforms import shift_and_scale

        warnings.warn(
            "The problem will be explicitly shifted and scaled. The shift and "
            "scaling feature is not supported in the general version of "
            "iar_chebyshev.")
        orgnep = nep

        def em(mu, vv):
            return float(compute_resnorm(orgnep, sigma_orig + gamma_orig * mu,
                                         vv))

        # real where they are real: a complex scale would make a DEP's
        # delays complex (the JAX package passes complex(sigma) and
        # complex(gamma) here, and its DEP raises on the delays)
        nep = shift_and_scale(nep, shift=sigma.real if sigma.imag == 0
                              else sigma,
                              scale=gamma.real if gamma.imag == 0 else gamma)
        sigma_orig, gamma_orig = sigma, gamma
        sigma, gamma = 0.0 + 0j, 1.0 + 0j
    lg.info(f"IAR Chebyshev with interval [{a},{b}]")
    cc = (a + b) / (a - b)
    kk = 2 / (b - a)
    n = nep.n
    m = maxit
    cdt = torch.complex128

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=cdt,
                               device=device)

    V = torch.zeros((n * (m + 1), m + 1), dtype=cdt, device=device)
    H = np.zeros((m + 1, m), dtype=complex)
    alpha = np.array([gamma ** i for i in range(m + 1)], dtype=complex)
    alpha[0] = 0.0
    M0inv = create_linsolver(linsolvercreator, nep, scalar_as(sigma, dtype))
    err_hist = np.ones((m, m + 1))
    lams = np.zeros(0, dtype=complex)
    Q = torch.zeros((n, 0), dtype=cdt, device=device)
    v0 = init_vec(v, n, dtype, device=device).to(cdt)
    V[:n, 0] = v0 / torch.linalg.vector_norm(v0)
    L = _L_matrix(m, a, b)
    L_t = dev(L)

    # precomputation per y0 method
    Tc = _cheb_vals(cc, m)
    Tc_t = dev(Tc)
    if compute_y0_method == ":DEP":
        Ttau = np.stack([_cheb_vals(-kk * t + cc, m + 1) for t in nep.tauv])
        # the -lam I term of get_Av takes no part: zero weight first
        Ttau = np.vstack([np.zeros((1, m + 2)), Ttau])
    elif compute_y0_method in (":PEP", ":SPMF"):
        Linv = np.linalg.inv(L[:m, :m])
        Dmat = np.vstack([np.zeros((1, m)), Linv[: m - 1, :]])
        if compute_y0_method == ":SPMF":
            DDs = sigma * np.eye(m) + gamma * Dmat
            DDf = [gamma * _dd0_mat_fun(f, DDs, sigma) for f in nep.get_fv()]
    elif not callable(compute_y0_method):
        P = np.column_stack(
            [_cheb2mon(kk, cc, np.eye(m + 1)[:, j]) for j in range(m + 1)]).T
        P_inv = np.column_stack(
            [_mon2cheb(kk, cc, np.eye(m + 1)[:, j]) for j in range(m + 1)]).T
        shift_kw = {}
    if callable(compute_y0_method):
        shift_kw = ({"sigma": sigma, "gamma": gamma}
                    if _accepts_shift(compute_y0_method) else {})

    def compute_y0(X, Y, k):
        if callable(compute_y0_method):
            y0 = compute_y0_method(nep, X, Y, k, M0inv, a, b, **shift_kw)
            return torch.as_tensor(y0, device=device).reshape(-1).to(cdt)
        if compute_y0_method == ":DEP":
            y0 = X @ Tc_t[:k] - _terms_apply(nep, Y[:, : k + 1],
                                             Ttau[:, : k + 1])
            return lin_solve(M0inv, y0).to(cdt)
        if compute_y0_method == ":PEP":
            D = np.zeros((len(nep.get_Av()), k), dtype=complex)
            vv = Tc[:k].astype(complex)
            for j in range(1, D.shape[0]):
                D[j] = vv
                vv = Dmat[:k, :k] @ vv
            y0 = -lin_solve(M0inv, _terms_apply(nep, X, D)).to(cdt)
            return y0 - Y[:, : k + 1] @ Tc_t[: k + 1]
        if compute_y0_method == ":SPMF":
            D = np.stack([Df[:k, :k] @ Tc[:k] for Df in DDf])
            y0 = -lin_solve(M0inv, _terms_apply(nep, X, D)).to(cdt)
            return y0 - Y[:, : k + 1] @ Tc_t[: k + 1]
        # generic: Chebyshev -> monomial -> one Taylor-IAR step -> back
        Y2 = torch.zeros((n, k + 1), dtype=cdt, device=device)
        Y2[:, 1:] = (X @ dev(P[:k, :k])) / dev(np.arange(1, k + 1))
        z = compute_Mlincomb(nep, sigma, Y2, alpha[: k + 1])
        Y2[:, 0] = -lin_solve(M0inv, z).to(cdt)
        Y[:, : k + 1] = Y2 @ dev(P_inv[: k + 1, : k + 1])
        return Y[:, 0]

    k = 1
    conv_eig = 0
    while k <= m and conv_eig < neigs:
        X = V[: n * k, k - 1].reshape(k, n).T
        y = torch.zeros((n, k + 1), dtype=cdt, device=device)
        if compute_y0_method != ":Generic":
            y[:, 1:] = X @ L_t[:k, :k]
        y[:, 0] = compute_y0(X, y, k)
        w, h, beta = orthogonalize_and_normalize(
            V[: n * (k + 1), :k], y.T.reshape(-1), orthmethod)
        H[:k, k - 1] = h.cpu().numpy()
        H[k, k - 1] = complex(beta)
        V[: n * (k + 1), k] = w

        if ((k % check_error_every == 0) or k == m) and k > 2:
            D, Z = np.linalg.eig(H[:k, :k])
            Q = V[:n, :k] @ dev(Z)
            lams = sigma + gamma / D
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
    if conv_eig < neigs and neigs != np.inf:
        msg = f"Number of iterations exceeded. maxit={maxit}."
        if conv_eig < 3:
            msg += " Check that sigma is not an eigenvalue."
        raise NoConvergenceException(lams, Q, err_hist, msg)
    if sigma_orig is not None:
        lams = sigma_orig + gamma_orig * lams
    nc = int(min(len(lams), conv_eig))
    return lams[:nc], Q[:, :nc]
