"""Fixed gallery problems and the gallery data files.

The NLEVP operand matrices ship with the JAX package as compressed CSR .npz
under ``neptpu/data``; the port reads them by file path (it never imports
that package).  ``NEPTPU_DATA_PATH`` overrides with a directory of either
.npz or text-serialized files.
"""
from __future__ import annotations

import os

import numpy as np

from ..dep import DEP

__all__ = ["dep1", "dep_symm_double", "dep_double", "data_dir",
           "read_sparse_matrix"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_VENDORED_DATA = os.path.join(_REPO, "neptpu", "data")


def data_dir():
    return os.environ.get("NEPTPU_DATA_PATH", _VENDORED_DATA)


def _load_npz(path):
    import scipy.sparse as sp

    with np.load(path) as z:
        return sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                             shape=tuple(z["shape"]))


def read_sparse_matrix(filename):
    """Text serialization: ``m n``, then the 1-based row indices, column
    indices and values of the COO triplets."""
    import scipy.sparse as sp

    with open(filename) as f:
        data = f.read().split()
    m, n = int(data[0]), int(data[1])
    c = (len(data) - 2) // 3
    I = np.array(data[2:2 + c], dtype=np.int64) - 1
    J = np.array(data[2 + c:2 + 2 * c], dtype=np.int64) - 1
    V = np.array(data[2 + 2 * c:2 + 3 * c], dtype=np.float64)
    return sp.csr_matrix(sp.coo_matrix((V, (I, J)), shape=(m, n)))


def _load(relpath):
    base = relpath.rsplit(".", 1)[0]
    for root in (data_dir(), _VENDORED_DATA):
        npz = os.path.join(root, base + ".npz")
        if os.path.exists(npz):
            return _load_npz(npz)
        txt = os.path.join(root, relpath)
        if os.path.exists(txt):
            return read_sparse_matrix(txt)
    raise FileNotFoundError(
        f"gallery data file {base}(.npz|.txt) not found under {data_dir()} "
        f"(nor {_VENDORED_DATA}); set NEPTPU_DATA_PATH to a directory holding "
        "the converted_* data")


def dep1(device=None):
    """DEP with one eigenvalue exactly 1."""
    A0 = np.array([[1.0, 2, 3], [4, 5, 6], [1, -1, 3]])
    A1 = (-A0 + np.array([[1.0, 0, 3], [0, 0, -1], [0, 0, 10]])) * np.e
    Q = np.array([[1.0, 0, 3], [1, 1, -4], [2, 3, 1]])
    A0 = np.linalg.solve(Q, A0 @ Q)
    A1 = np.linalg.solve(Q, A1 @ Q)
    return DEP([A0, A1], [0.0, 1.0], device=device)


def dep_symm_double(n: int = 100, device=None):
    """Symmetric DEP with double eigenvalues (Voss & Betcke 2017) on an
    n x n grid: size n^2, delays 0 and 2, a 9-diagonal bank."""
    import scipy.sparse as sp

    main = -2.0 * np.ones(n)
    off = np.ones(n - 1)
    LL = sp.diags([off, main, off], [-1, 0, 1], format="csr")
    x = np.linspace(0, np.pi, n)
    h = x[1] - x[0]
    LL = LL / h**2
    LL = sp.kron(LL, LL, format="csr")
    X, Y = np.meshgrid(x, x, indexing="ij")
    b = -100.0 * np.abs(np.sin(X + Y))
    a = 8.0 * np.sin(X) * np.sin(Y)
    # grid function (i, j) -> row j*n + i: column-major flatten
    B = sp.diags(b.flatten(order="F")).tocsr()
    A = LL + sp.diags(a.flatten(order="F")).tocsr()
    return DEP([A, B], [0.0, 2.0], device=device)


def dep_double(device=None):
    """DEP with a double non-semisimple eigenvalue at 3*pi*i (Jarlebring
    2012)."""
    pi = np.pi
    denom = 8 + 5 * pi
    a1 = 2 / 5 * (65 * pi + 32) / denom
    a2 = 9 * pi**2 * (13 + 5 * pi) / denom
    a3 = 324 / 5 * pi**2 * (5 * pi + 4) / denom
    b1 = (260 * pi + 128 + 225 * pi**2) / (10 * denom)
    b2 = 45 * pi**2 / denom
    b3 = 81 * pi**2 * (40 * pi + 32 + 25 * pi**2) / (10 * denom)
    A0 = np.array([[0.0, 1, 0], [0, 0, 1], [-a3, -a2, -a1]])
    A1 = np.array([[0.0, 0, 0], [0, 0, 0], [-b3, -b2, -b1]])
    return DEP([A0, A1], [0.0, 1.0], device=device)
