"""Native NLEVP benchmarks: ``gun_like``, a problem with the gun structure
(n ~ 9956, PEP(K, -M) + 2-term i*sqrt SPMF), and the loaded string (a
rational problem)."""
from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device
from ...ops import matfun
from ..pep import PEP
from ..spmf import SPMF_NEP
from ..sumnep import SPMFSumNEP, SumNEP
from .examples import _load

__all__ = ["gun_like", "GUN_SIGMA2", "nlevp_native_loaded_string"]

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
