"""Native implementations of NLEVP benchmarks: gun, cd_player, fiber,
hadeler, pdde_stability, loaded_string, and ``gun_like``, a problem with
the gun structure (n ~ 9956, PEP(K, -M) + 2-term i*sqrt SPMF) for runs
without the gun's K and M data files.

The gun and cd_player operand matrices are read from the ``converted_nlevp``
data files when present (the package data holds only gun_W1/W2 and
cd_player C/K, so ``nlevp_native_gun`` raises ``FileNotFoundError``)."""
from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...ops import matfun
from ..pep import PEP
from ..spmf import SPMF_NEP
from ..sumnep import SPMFSumNEP, SumNEP
from .examples import _load

__all__ = [
    "nlevp_native_gun",
    "gun_like",
    "GUN_SIGMA2",
    "nlevp_native_cd_player",
    "nlevp_native_fiber",
    "nlevp_native_hadeler",
    "nlevp_native_pdde_stability",
    "nlevp_native_loaded_string",
]

GUN_SIGMA2 = 108.8774  # second branch point sqrt(lam - sigma2^2)


def _i_sqrt_shifted(c):
    """f(S) = i * sqrt(S - c I) with exact host-side derivatives
    d^j/dl^j [i sqrt(l-c)] = i sqrt(l-c) prod_{t<j} (1/2 - t) / (l-c)^j."""

    def f(S):
        if c == 0.0:
            return 1j * matfun.sqrtm(S)
        return 1j * matfun.sqrtm(S - c * matfun.eye_like(S))

    def derivs(lam, k):
        z = complex(lam) - c
        out = np.zeros(k, dtype=complex)
        coef = 1j * np.sqrt(z + 0j)
        out[0] = coef
        for j in range(1, k):
            coef = coef * (0.5 - (j - 1)) / z
            out[j] = coef
        return out

    return matfun.with_derivs(f, derivs)


def _gun_from_matrices(K, M, W1, W2, device=None):
    pep = PEP([K, -M], device=device)
    sqrtnep = SPMF_NEP([W1, W2],
                       [_i_sqrt_shifted(0.0), _i_sqrt_shifted(GUN_SIGMA2**2)],
                       device=device)
    return SumNEP(pep, sqrtnep)


def nlevp_native_gun(device=None):
    """The RF gun cavity; needs the data files gun_{K,M,W1,W2}."""
    K = _load("converted_nlevp/gun_K.txt")
    M = _load("converted_nlevp/gun_M.txt")
    W1 = _load("converted_nlevp/gun_W1.txt")
    W2 = _load("converted_nlevp/gun_W2.txt")
    return _gun_from_matrices(K, M, W1, W2, device=resolve_device(device))


def gun_like(n=None, seed=0, device=None):
    """Synthetic problem with the gun structure: K/M from a 2D 5-point
    Laplacian + mass matrix, W1/W2 the gun boundary matrices when the data
    files are available (else synthetic low-density boundary terms made with
    numpy from ``seed``)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    try:
        W1 = _load("converted_nlevp/gun_W1.txt")
        W2 = _load("converted_nlevp/gun_W2.txt")
        n = W1.shape[0]
    except FileNotFoundError:
        if n is None:
            n = 9956
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=64, replace=False)
        vals = rng.standard_normal((64, 64))
        W1 = sp.csr_matrix((vals.ravel(), (np.repeat(idx, 64),
                                           np.tile(idx, 64))), shape=(n, n))
        W2 = W1.T.tocsr()
    nx = int(np.ceil(np.sqrt(n)))
    L1 = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                  [-1, 0, 1])
    L2d = sp.kron(L1, sp.eye(nx)) + sp.kron(sp.eye(nx), L1)
    K = (L2d.tocsr()[:n, :n] * (nx + 1) ** 2).tocsr()
    M = sp.diags(np.full(n, 1.0) + 0.1 * np.cos(np.arange(n))).tocsr()
    return _gun_from_matrices(K, M, W1, W2, device=device)


def nlevp_native_cd_player(device=None):
    """The CD player QEP (data files cd_player_{C,K})."""
    device = resolve_device(device)
    K = _load("converted_nlevp/cd_player_K.txt").toarray()
    C = _load("converted_nlevp/cd_player_C.txt").toarray()
    M = np.eye(K.shape[0])
    return PEP([K, C, M], device=device)


# -- fiber ------------------------------------------------------------------


def _construct_newton_matrix(ff, pts):
    """Newton interpolation matrix and samples in high precision."""
    import mpmath as mp

    m = len(pts)
    NM = mp.zeros(m, m)
    for row in range(m):
        NM[row, 0] = mp.mpc(1)
    for col in range(1, m):
        for row in range(col, m):
            NM[row, col] = NM[row, col - 1] * (pts[row] - pts[col - 1])
    f = mp.matrix([ff(p) for p in pts])
    return NM, f


def _newton_eval(coeffs, S, pts):
    """The Newton form at a scalar or matrix ``S``."""
    I = matfun.eye_like(S)
    F = complex(coeffs[0]) * I
    prod = I
    for k in range(1, len(coeffs)):
        prod = (prod @ (S - complex(pts[k - 1]) * I) if S.ndim >= 2
                else prod * (S - complex(pts[k - 1])))
        F = F + prod * complex(coeffs[k])
    return F


def nlevp_native_fiber(device=None):
    """Fiber optics problem, its Bessel-quotient term replaced by a Newton
    interpolant computed in high precision (mpmath, 50 digits)."""
    device = resolve_device(device)
    import mpmath as mp
    import scipy.sparse as sp

    L = 2400.0
    mp.mp.dps = 50

    def besselk(m_, z):
        return mp.besselk(m_, z)

    def besselkp(m_, z):
        return -besselk(m_ - 1, z) - m_ * besselk(m_, z) / z

    def numer(x):
        return ((L + 0.5) / L**2) * x / (besselk(1, mp.mpc(x)) ** 2)

    def denom(x):
        return 1 / (besselkp(1, mp.mpc(x)) * besselk(1, mp.mpc(x)))

    m = 10
    pts = [mp.mpc(0.01 + 3.0 * i / (m - 1)) for i in range(m)]
    NM, fnum = _construct_newton_matrix(numer, pts)
    _, fden = _construct_newton_matrix(denom, pts)
    num_coeffs = mp.lu_solve(NM, fnum)
    den_coeffs = mp.lu_solve(NM, fden)
    pts64 = np.array([complex(p) for p in pts])
    num64 = np.array([complex(c) for c in num_coeffs])
    den64 = np.array([complex(c) for c in den_coeffs])

    def f3(S):
        # s3(lam) = denom(sqrt(lam) L)^{-1} numer(sqrt(lam) L)
        X = matfun.sqrtm(S) * L
        Fn = _newton_eval(num64, X, pts64)
        Fd = _newton_eval(den64, X, pts64)
        if S.ndim >= 2:
            # a singular Fd gives non-finite values for the solver's error
            # measure to judge, as LAPACK's gesv does: no exception
            return torch.linalg.solve_ex(Fd, Fn)[0]
        return Fn / Fd

    eta_cl = 1.4969
    alpha, ell = 25, 1.1
    gam, delta = 0.003, 0.01
    k_cl = 2 * np.pi * eta_cl / ell
    n_c = 400
    n = 6 * n_c
    mm = 1
    inc = np.arange(1, n_c + 1)
    i_n = np.arange(n_c + 1, n)
    C = np.sqrt((1 - 2 * gam * (inc / n_c) ** alpha) / (1 - 2 * gam)) - 1
    eta0 = eta_cl + 1.4201 * C
    kfun = 2 * np.pi * eta0 / ell
    e = np.ones(n_c)
    y1 = -2 * e - mm**2 * (e / inc**2) + delta**2 * (kfun**2 - k_cl**2)
    e2 = np.ones(len(i_n))
    y2 = -2 * e2 - mm**2 * (e2 / i_n**2)
    y = np.concatenate([y1, y2, [-1 + 1 / (2 * n) - mm**2 / n**2]])
    i = np.arange(1, n)
    z = (i + 0.5) / np.sqrt(i * (i + 1.0))
    A0 = sp.diags([z, y[:n], z], [-1, 0, 1]).tocsr()
    A2 = sp.csr_matrix(([1.0], ([n - 1], [n - 1])), shape=(n, n))
    A1 = sp.eye(n, format="csr")
    return SPMF_NEP([A0, A1, A2], [matfun.eye_like, lambda S: -S, f3],
                    device=device)


def nlevp_native_hadeler(alpha=100.0, n=8, device=None):
    """The Hadeler problem."""
    device = resolve_device(device)
    i = np.arange(1, n + 1)
    I2 = np.outer(np.ones(n), i)
    II = np.eye(n)
    A0 = alpha * II
    A2 = n * II + 1.0 / (I2 + I2.T)
    B = ((n + 1) - np.maximum(I2.T, I2)) * np.outer(i, i)
    fv = [lambda S: -matfun.eye_like(S),
          lambda S: S @ S if S.ndim >= 2 else S**2,
          lambda S: matfun.expm(S) - matfun.eye_like(S)]
    return SPMF_NEP([A0, A2, B], fv, device=device)


def nlevp_native_pdde_stability(n=15, device=None):
    """The PDDE-stability QEP (size n^2)."""
    device = resolve_device(device)
    import scipy.sparse as sp

    a0, b0, a1, b1, a2, b2 = 2.0, 0.3, -2.0, 0.2, -2.0, -0.3
    t1 = -np.pi / 2
    h = np.pi / (n + 1)
    x = np.arange(1, n + 1) * h
    e = np.ones(n)
    A0 = sp.diags([e[:-1], -2 * e, e[:-1]], [-1, 0, 1]) / h**2
    A0 = (A0 + sp.diags(a0 + b0 * np.sin(x))).tocsr()
    A1 = sp.diags(a1 + b1 * x * (1 - np.exp(x - np.pi))).tocsr()
    A2 = sp.diags(a2 + b2 * x * (np.pi - x)).tocsr()
    II = sp.eye(n, format="csr", dtype=complex)
    E = sp.kron(II, A2).tocsr()
    gamma = np.exp(1j * t1)
    gamma = gamma / abs(gamma)
    F = (sp.kron(II, (A0 - gamma * A1))
         + sp.kron((A0 + gamma * A1), II)).tocsr()
    p = np.arange(n * n).reshape(n, n).T.ravel()
    Ep = E[p, :][:, p]
    return PEP([Ep, F, E], device=device)


def _toeplitz(v):
    n = len(v)
    T = np.zeros((n, n), dtype=float)
    for i in range(n):
        for j in range(n - i):
            T[i, j + i] = v[j]
            T[j + i, i] = v[j]
    return T


def nlevp_native_loaded_string(n=20, kappa=1.0, m=1.0, device=None):
    """The loaded-string rational problem of NLEVP:
    ``M(lam) = A - lam B + lam / (lam - kappa/m) C``."""
    import scipy.sparse as sp

    device = resolve_device(device)
    A0 = sp.csr_matrix(_toeplitz([2.0 * n, -n] + [0.0] * (n - 2)))
    A1 = np.zeros((n, n))
    A1[n - 1, n - 1] = n - A0[n - 1, n - 1]
    B0 = sp.csr_matrix(_toeplitz([4 / (6 * n), 1 / (6 * n)] + [0.0] * (n - 2)))
    B1 = np.zeros((n, n))
    B1[n - 1, n - 1] = 2 / (6 * n) - B0[n - 1, n - 1]
    Cm = np.zeros((n, n))
    Cm[n - 1, n - 1] = kappa
    sigma = kappa / m

    def f2(S):
        return -S

    def f3(S):
        if S.ndim >= 2:
            return torch.linalg.solve(S - sigma * matfun.eye_like(S), S)
        return S / (S - sigma)

    spmf1 = SPMF_NEP([A0, B0], [matfun.eye_like, f2], device=device)
    spmf2 = SPMF_NEP([sp.csr_matrix(A1), sp.csr_matrix(B1), sp.csr_matrix(Cm)],
                     [matfun.eye_like, f2, f3], device=device)
    return SPMFSumNEP(spmf1, spmf2)
