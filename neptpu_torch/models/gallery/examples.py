"""Fixed gallery problems and the gallery data files.

The NLEVP operand matrices ship with the JAX package as compressed CSR .npz
under ``neptpu/data``; the port reads them by file path (it never imports
that package).  ``NEPTPU_DATA_PATH`` overrides with a directory of either
.npz or text-serialized files.
"""
from __future__ import annotations

import os

import numpy as np

from ...config import resolve_device

from ...ops import matfun
from ...utils.serialization import read_sparse_matrix
from ..dep import DEP
from ..pep import PEP
from ..spmf import SPMF_NEP

__all__ = ["dep1", "dep_symm_double", "dep_double", "real_quadratic",
           "qdep0", "qdep1", "neuron0", "beam", "sine_nep", "data_dir",
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


def real_quadratic(device=None):
    """Quadratic PEP with four known real eigenvalues."""
    device = resolve_device(device)
    A0 = np.array(
        [[4.0, 0, 1, 1], [0, 2, 1, 1], [1, 1, 6, -2], [1, 1, -2, 3]])
    A1 = np.array([[167.0, -140, 95, -131], [-140, 327, 54, 85],
                   [95, 54, 235, -81], [-131, 85, -81, 181]])
    A2 = np.array(
        [[2.0, 1, -1, -1], [1, 5, -3, 2], [-1, -3, 3, 0], [-1, 2, 0, 3]])
    return PEP([A0, A1, A2], device=device)


def _square(S):
    return S @ S


def qdep0(device=None):
    """Quadratic delay problem of the infinite bi-Lanczos paper (data
    files ``converted_misc/qdep_infbilanczos_A{0,1}``)."""
    device = resolve_device(device)
    import scipy.sparse as sp

    A0 = _load("converted_misc/qdep_infbilanczos_A0.txt")
    A1 = _load("converted_misc/qdep_infbilanczos_A1.txt")
    tau = 1.0
    I = sp.eye(A0.shape[0], format="csr")
    return SPMF_NEP([-I, A0, A1],
                    [_square, matfun.eye_like,
                     lambda S: matfun.expm(-tau * S)], device=device)


def qdep1(device=None):
    """Quadratic delay problem (Jarlebring/Michiels/Meerbergen)."""
    device = resolve_device(device)
    A0 = np.array([[0.3, -0.6, 0.0, 0.4], [-0.3, 0.4, -0.8, 1.9],
                   [0.1, -1.6, -1.3, 0.0], [-1.4, -0.9, 0.2, 0.9]])
    A1 = np.array([[0.8, 0.2, -1.3, -0.3], [-1.1, 0.9, 1.2, 0.5],
                   [0.5, 0.2, -1.6, -1.3], [0.7, 0.4, -0.4, 0.0]])
    I = np.eye(4)
    return SPMF_NEP([I, A0, A1],
                    [lambda S: -(S @ S), matfun.eye_like,
                     lambda S: matfun.expm(-S)], device=device)


def neuron0(device=None):
    """Coupled-neuron delay differential equation (Shayer & Campbell
    2000)."""
    device = resolve_device(device)
    kappa = 0.5
    beta = -1.0
    a21 = 2.34
    a12 = 1.0
    x = np.array([0.0, 0.0])
    tauv = [0.0, 0.2, 0.2, 1.5]
    A0 = -kappa * np.eye(2)
    A1 = a21 * np.array([[0.0, 0.0], [1 - np.tanh(x[1]) ** 2, 0.0]])
    A2 = a12 * np.array([[0.0, 1 - np.tanh(x[0]) ** 2], [0.0, 0.0]])
    A3 = beta * np.diag([1 - np.tanh(x[0]) ** 2, 1 - np.tanh(x[1]) ** 2])
    return DEP([A0, A1, A2, A3], tauv, device=device)


def beam(n: int = 100, device=None):
    """Delay problem modelling a beam."""
    device = resolve_device(device)
    import scipy.sparse as sp

    h = 1.0 / n
    ee = np.ones(n)
    A0 = sp.diags([ee[: n - 1], -2 * ee, ee[: n - 1]], [-1, 0, 1]).tolil()
    A0[n - 1, n - 1] = 1 / h
    A0[n - 1, n - 2] = -1 / h
    A0 = A0.tocsr()
    A1 = sp.csr_matrix(([1.0], ([n - 1], [n - 1])), shape=(n, n))
    return DEP([A0, A1], [0.0, 1.0], device=device)


def sine_nep(device=None):
    """PEP + rank-2 matrix-sine term (data files ``converted_sine``)."""
    from .lowrank_sum import make_sine_nep

    return make_sine_nep(_load, device=device)
