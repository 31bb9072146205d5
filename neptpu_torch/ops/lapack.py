"""Small dense (generalized) eigen and Schur solves.

These are k x k with k up to a few hundred and sit off the hot path (Ritz
extraction, projected problems, matrix square roots).  ``eig`` and ``eigvals``
run through ``torch.linalg`` on the device of their argument; ``geig``,
``schur``, ``ordschur_inside`` and ``qz`` have no torch counterpart and run on
the host through scipy, the result going back to the argument's device.  All
results are complex128.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["eig", "eigvals", "geig", "schur", "ordschur_inside", "qz"]

_C = torch.complex128


def _c128(A):
    return torch.as_tensor(A).to(_C)


def _host(A):
    return _c128(A).detach().cpu().numpy()


def _back(like, *arrays):
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=_C,
                                 device=dev) for a in arrays)


def eig(A):
    """Eigen-decomposition of a general square matrix: returns (w, V)."""
    w, V = torch.linalg.eig(_c128(A))
    return w, V


def eigvals(A):
    return torch.linalg.eigvals(_c128(A))


def geig(A, B):
    """Generalized eigenproblem A x = lam B x: returns (w, V).  LAPACK's QZ
    on the host, so a singular B gives infinite eigenvalues (``inf`` or
    ``nan`` entries of w) instead of failing."""
    import scipy.linalg as sla

    w, V = sla.eig(_host(A), _host(B))
    return _back(A, w, V)


def schur(A):
    """Complex Schur decomposition A = Z T Z^H: returns (T, Z)."""
    import scipy.linalg as sla

    T, Z = sla.schur(_host(A), output="complex")
    return _back(A, T, Z)


def ordschur_inside(A, center, radius):
    """Schur form with the eigenvalues inside ``|lam - center| < radius``
    ordered first.  Returns ``(T, Z, count)``, ``count`` the number of
    selected eigenvalues (an int)."""
    import scipy.linalg as sla

    c, r = complex(center), float(np.real(radius))
    TT, ZZ = sla.schur(_host(A), output="complex",
                       sort=lambda x: abs(x - c) < r)[:2]
    cnt = int(np.sum(np.abs(np.diag(TT) - c) < r))
    return _back(A, TT, ZZ) + (cnt,)


def qz(A, B):
    """Generalized (QZ) Schur decomposition: returns (AA, BB, Q, Z)."""
    import scipy.linalg as sla

    AA, BB, Q, Z = sla.qz(_host(A), _host(B), output="complex")
    return _back(A, AA, BB, Q, Z)
