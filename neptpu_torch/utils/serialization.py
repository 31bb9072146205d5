"""Text serialization of sparse matrices: the file holds nrows, ncols, then
the 1-based row indices, column indices and values, one number per line."""
from __future__ import annotations

import numpy as np

__all__ = ["read_sparse_matrix", "write_sparse_matrix"]


def write_sparse_matrix(filename, M):
    """Write a scipy sparse matrix (or array) in the text format."""
    import scipy.sparse as sp

    M = sp.coo_matrix(M)
    with open(filename, "w") as f:
        f.write(f"{M.shape[0]}\n{M.shape[1]}\n")
        for r in M.row:
            f.write(f"{r + 1}\n")
        for c in M.col:
            f.write(f"{c + 1}\n")
        for v in M.data:
            f.write(f"{float(v)}\n")


def read_sparse_matrix(filename):
    """A scipy CSR matrix from the text format (duplicates summed)."""
    import scipy.sparse as sp

    with open(filename) as f:
        data = f.read().split()
    m, n = int(data[0]), int(data[1])
    c = (len(data) - 2) // 3
    I = np.array(data[2:2 + c], dtype=np.int64) - 1
    J = np.array(data[2 + c:2 + 2 * c], dtype=np.int64) - 1
    V = np.array(data[2 + 2 * c:2 + 3 * c], dtype=np.float64)
    return sp.csr_matrix(sp.coo_matrix((V, (I, J)), shape=(m, n)))
