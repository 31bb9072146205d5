"""Inner *linear* eigensolvers, used by ``mslp``, ``sgiter`` and ``polyeig``.

* ``EigenEigSolver``: dense (generalized) eig through ``ops/lapack.py``
  (``torch.linalg.eig`` on the matrix's device; the generalized problem on
  the host through scipy).
* ``ArnoldiEigSolver``: shift-invert Arnoldi.  The LU of ``target*B - A`` and
  the Arnoldi basis stay on the problem's device; only the small Hessenberg
  ``H`` comes to the host for its eigen-decomposition.
* ``DefaultEigSolver``: Arnoldi for a CSR operand larger than 400, else
  dense - the JAX package's test, which looks for its ``CSR`` class only.  So
  a DIA operand (``compute_Mder`` of a banded problem returns a single-term
  ``DiaTermBank`` in both packages) takes the dense branch in each: the port
  forms it dense, the JAX package's dense branch cannot convert it and raises
  ``TypeError``.

Results are complex128 tensors on the operand's device, sorted by distance
to the target.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lapack
from .sparse import CSR

__all__ = [
    "EigSolver",
    "EigenEigSolver",
    "ArnoldiEigSolver",
    "DefaultEigSolver",
    "eig_solve",
]

_C = torch.complex128


def _is_sparse(A):
    return isinstance(A, CSR)


def _dense(A):
    return A if isinstance(A, torch.Tensor) else A.to_dense()


class EigSolver:
    def solve(self, nev=1, target=0.0):
        raise NotImplementedError


def eig_solve(solver: EigSolver, nev=1, target=0.0):
    """Returns ``(D, V)``: eigenvalues sorted by distance to ``target``."""
    return solver.solve(nev=nev, target=target)


class EigenEigSolver(EigSolver):
    def __init__(self, A, B=None):
        self.A = _dense(A)
        self.B = None if B is None else _dense(B)

    def solve(self, nev=1, target=0.0):
        if self.B is None:
            D, V = lapack.eig(self.A)
        else:
            D, V = lapack.geig(self.A, self.B)
        order = torch.argsort(torch.abs(D - complex(target)))[:nev]
        return D[order], V[:, order]


class ArnoldiEigSolver(EigSolver):
    """Shift-invert Arnoldi: the largest eigenvalues of
    ``(target*B - A)^{-1} B``, mapped back by ``D = target - 1/D0``."""

    def __init__(self, A, B=None, maxdim: int = 80, tol: float = 1e-10):
        self.A = A
        self.B = B
        self.maxdim = maxdim
        self.tol = tol

    def solve(self, nev=1, target=0.0):
        A = _dense(self.A).to(_C)
        n = A.shape[0]
        dev = A.device
        B = (torch.eye(n, dtype=_C, device=dev) if self.B is None
             else _dense(self.B).to(_C))
        lu, piv = torch.linalg.lu_factor(complex(target) * B - A)

        def op(x):
            return torch.linalg.lu_solve(lu, piv, (B @ x)[:, None])[:, 0]

        m = min(self.maxdim, n)
        v0 = torch.as_tensor(np.random.default_rng(1).standard_normal(n),
                             dtype=_C, device=dev)
        V = torch.zeros((n, m + 1), dtype=_C, device=dev)
        H = np.zeros((m + 1, m), dtype=complex)
        V[:, 0] = v0 / torch.linalg.vector_norm(v0)
        k_eff = m
        for k in range(m):
            w = op(V[:, k])
            # DGKS two-pass reorthogonalization
            for _ in range(2):
                h = V[:, : k + 1].conj().T @ w
                w = w - V[:, : k + 1] @ h
                H[: k + 1, k] += h.cpu().numpy()
            beta = float(torch.linalg.vector_norm(w))
            H[k + 1, k] = beta
            if beta < 1e-14:
                k_eff = k + 1
                break
            V[:, k + 1] = w / beta
        D0, Z = np.linalg.eig(H[:k_eff, :k_eff])
        order = np.argsort(-np.abs(D0))[:nev]
        D = complex(target) - 1.0 / D0[order]
        Vout = V[:, :k_eff] @ torch.as_tensor(Z[:, order], dtype=_C,
                                              device=dev)
        return torch.as_tensor(D, dtype=_C, device=dev), Vout


class DefaultEigSolver(EigSolver):
    def __init__(self, A, B=None):
        if _is_sparse(A) and A.shape[0] > 400:
            self.sub = ArnoldiEigSolver(A, B)
        else:
            self.sub = EigenEigSolver(A, B)

    def solve(self, nev=1, target=0.0):
        return self.sub.solve(nev=nev, target=target)
