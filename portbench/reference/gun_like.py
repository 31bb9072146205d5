"""Plain float64 reference of the ``gun_like`` configuration.

M(lam) = K - lam M + i sqrt(lam) W1 + i sqrt(lam - sigma2^2) W2 (the RF gun
cavity of the NLEVP collection), with the gun's own boundary matrices W1
and W2 read from their data files, and, since the gun's K and M files are
not in the repository, K the 2D five-point Laplacian on an nx x nx grid cut
to n rows and scaled by (nx + 1)^2, and M = diag(1 + 0.1 cos i).  Square
roots take the principal branch.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp

from ._spmf import SPMFReference


def read_csr(path):
    """A CSR matrix stored as ``data``, ``indices``, ``indptr``, ``shape``."""
    with np.load(path) as z:
        return sp.csr_matrix((z["data"], z["indices"], z["indptr"]),
                             shape=tuple(z["shape"]))


def matrices(cfg, root):
    """``[K, M, W1, W2]`` in float64, from the configuration's data files."""
    W1 = read_csr(os.path.join(root, cfg["data"]["W1"]))
    W2 = read_csr(os.path.join(root, cfg["data"]["W2"]))
    n = W1.shape[0]
    if n != cfg["n"]:
        raise ValueError(f"W1 has {n} rows, the configuration says {cfg['n']}")
    nx = int(np.ceil(np.sqrt(n)))
    T = sp.diags([-np.ones(nx - 1), 2.0 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    lap = sp.kron(T, sp.eye(nx)) + sp.kron(sp.eye(nx), T)
    K = sp.csr_matrix(lap.tocsr()[:n, :n] * float(nx + 1) ** 2)
    M = sp.diags(1.0 + 0.1 * np.cos(np.arange(n))).tocsr()
    return [K, M, W1, W2]


def build(cfg, root):
    c2 = float(cfg["sigma2"]) ** 2

    def weights(lams):
        lams = np.asarray(lams, dtype=complex)
        return np.stack([np.ones_like(lams), -lams, 1j * np.sqrt(lams),
                         1j * np.sqrt(lams - c2)])

    return SPMFReference(matrices(cfg, root), weights)
