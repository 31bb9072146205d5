"""Compact low-rank factors of boundary-supported sparse terms."""
from __future__ import annotations

import numpy as np

__all__ = ["low_rank_factors"]


def low_rank_factors(A, tol=None):
    """Compact factors ``A = L @ U^H`` of a (sparse) matrix whose nonzeros
    live in a small set of rows/columns: an SVD of the compacted nonzero
    block (exact for scattered supports).  Host numpy; returns ``(L, U)``."""
    import scipy.sparse as sp

    if sp.issparse(A):
        Ac = A.tocoo()
        n, m = Ac.shape
        if Ac.nnz == 0:
            return np.zeros((n, 0)), np.zeros((m, 0))
        urows = np.unique(Ac.row)
        ucols = np.unique(Ac.col)
        B = np.asarray(Ac.tocsr()[urows][:, ucols].toarray())
    else:
        B = np.asarray(A)
        n, m = B.shape
        urows = np.arange(n)
        ucols = np.arange(m)
    Us, s, Vh = np.linalg.svd(B, full_matrices=False)
    if tol is None:
        tol = max(B.shape) * np.finfo(s.dtype).eps * (s[0] if s.size else 0.0)
    r = int(np.sum(s > tol))
    L = np.zeros((n, r), dtype=B.dtype)
    U = np.zeros((m, r), dtype=B.dtype)
    L[urows] = Us[:, :r] * s[:r]
    U[ucols] = Vh[:r].conj().T
    return L, U
