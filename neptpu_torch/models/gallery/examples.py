"""Gallery data files.

The NLEVP operand matrices ship with the JAX package as compressed CSR .npz
under ``neptpu/data``; the port reads them by file path (it never imports
that package).  ``NEPTPU_DATA_PATH`` overrides with a directory of either
.npz or text-serialized files.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["data_dir", "read_sparse_matrix"]

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
