"""Native NLEVP benchmarks: ``gun_like``, a problem with the gun structure
(n ~ 9956, PEP(K, -M) + 2-term i*sqrt SPMF)."""
from __future__ import annotations

import numpy as np

from ...config import resolve_device
from ...ops import matfun
from ..pep import PEP
from ..spmf import SPMF_NEP
from ..sumnep import SumNEP
from .examples import _load

__all__ = ["gun_like", "GUN_SIGMA2"]

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
