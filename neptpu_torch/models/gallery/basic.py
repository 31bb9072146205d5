"""Reproducible random gallery problems (the MSWS generator makes their
matrices identical across releases and languages).  ``device``: where the
problem's term bank lives (default: the card)."""
from __future__ import annotations

import numpy as np

from ..dep import DEP
from ..pep import PEP
from .msws import MSWS_RNG

__all__ = [
    "dep0",
    "dep0_sparse",
    "dep0_tridiag",
    "pep0",
    "pep0_sym",
    "pep0_sparse",
    "qep_fixed_eig",
]


def dep0(n: int = 5, device=None):
    rng = MSWS_RNG()
    A0 = rng.gen_mat(n, n)
    A1 = rng.gen_mat(n, n)
    return DEP([A0, A1], [0.0, 1.0], device=device)


def dep0_sparse(n: int = 100, p: float = 0.25, device=None):
    import scipy.sparse as sp

    rng = MSWS_RNG()
    A0 = sp.diags(rng.gen_mat(n, 1).ravel()).tocsr() + rng.gen_spmat(n, n, p)
    A1 = sp.diags(rng.gen_mat(n, 1).ravel()).tocsr() + rng.gen_spmat(n, n, p)
    return DEP([A0, A1], [0.0, 1.0], device=device)


def dep0_tridiag(n: int = 100, device=None):
    import scipy.sparse as sp

    rng = MSWS_RNG()
    K = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    J = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    A0 = sp.csr_matrix(
        sp.coo_matrix((rng.gen_mat(3 * n - 2, 1).ravel(), (K, J)), shape=(n, n))
    )
    A1 = sp.csr_matrix(
        sp.coo_matrix((rng.gen_mat(3 * n - 2, 1).ravel(), (K, J)), shape=(n, n))
    )
    return DEP([A0, A1], [0.0, 1.0], device=device)


def pep0(n: int = 200, device=None):
    rng = MSWS_RNG()
    return PEP([rng.gen_mat(n, n), rng.gen_mat(n, n), rng.gen_mat(n, n)],
               device=device)


def pep0_sym(n: int = 200, device=None):
    rng = MSWS_RNG()

    def symm(A):
        # the upper triangle mirrored
        return np.triu(A) + np.triu(A, 1).T

    return PEP([symm(rng.gen_mat(n, n)) for _ in range(3)], device=device)


def pep0_sparse(n: int = 200, p: float = 0.03, device=None):
    rng = MSWS_RNG()
    return PEP([rng.gen_spmat(n, n, p) for _ in range(3)], device=device)


def qep_fixed_eig(n: int = 5, E=None, device=None):
    """Quadratic eigenproblem with prescribed eigenvalues E:
    lam^2 I - lam (A1+A2) + A1 A2."""
    if E is None:
        rng = MSWS_RNG()
        E = rng.gen_mat(2 * n, 1).ravel()
    E = np.asarray(E, dtype=float)
    A1 = np.diag(E[:n])
    A2 = np.diag(E[n : 2 * n])
    K = np.eye(n)
    return PEP([A1 @ A2, -A1 - A2, K], device=device)
