"""Plain float64 reference of the ``dep_symm_double`` configuration.

M(lam) = -lam I + A + exp(-tau lam) B (NEP-PACK's gallery problem
``dep_symm_double``, ``gallery_examples.jl``: Voss & Betcke), on a g x g
grid of x in [0, pi]: with T the second-difference matrix over h^2,
A = kron(T, T) + diag(8 sin x_i sin y_j) and B = diag(-100 |sin(x_i + y_j)|),
the grid point (i, j) being row j g + i.  The backward error divides by
|lam| sqrt(n) + |f_A| ||A||_F + |f_B| ||B||_F (``benchmarks/time_to_tol.py``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ._spmf import SPMFReference


def matrices(cfg, root=None):
    """``[I, A, B]`` in float64 on the configuration's grid."""
    g = int(cfg["grid"])
    x = np.linspace(0.0, np.pi, g)
    h = x[1] - x[0]
    T = sp.diags([np.ones(g - 1), -2.0 * np.ones(g), np.ones(g - 1)],
                 [-1, 0, 1]) / h**2
    X, Y = np.meshgrid(x, x, indexing="ij")
    A = sp.kron(T, T) + sp.diags((8.0 * np.sin(X) * np.sin(Y)).ravel("F"))
    B = sp.diags((-100.0 * np.abs(np.sin(X + Y))).ravel("F"))
    return [sp.eye(g * g, format="csr"), A.tocsr(), B.tocsr()]


def build(cfg, root=None):
    tau = [float(t) for t in cfg["delays"]]

    def weights(lams):
        lams = np.asarray(lams, dtype=complex)
        return np.stack([-lams] + [np.exp(-t * lams) for t in tau])

    return SPMFReference(matrices(cfg, root), weights)
