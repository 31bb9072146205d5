"""Companion linearization and a linear eigensolve for polynomial NEPs:
``companion`` (Mehrmann-Voss form), ``polyeig`` for a monomial PEP and the
Chebyshev colleague-matrix ``polyeig`` for a ChebPEP (Amiraslani, Corless
and Lancaster; Effenberger and Kressner).

The pencils are dense ``dn x dn`` tensors on the problem's device; the
generalized eigensolve runs on the host (``ops/lapack.geig``).  Returns the
eigenvalues as a complex128 tensor and the eigenvectors' first n rows.
"""
from __future__ import annotations

import torch

from ..models.cheb import ChebPEP
from ..ops import lapack
from ..ops.eigsolve import DefaultEigSolver, eig_solve

__all__ = ["companion", "polyeig"]


def _dense(A):
    return A if isinstance(A, torch.Tensor) else A.to_dense()


def companion(pep):
    """Companion pencil ``(E, A)`` with ``A x = lam E x`` of size dn x dn."""
    n, d = pep.n, pep.degree
    Av = [_dense(A) for A in pep.get_Av()]
    dt, dev = Av[0].dtype, Av[0].device
    E = torch.zeros((d * n, d * n), dtype=dt, device=dev)
    A = torch.zeros((d * n, d * n), dtype=dt, device=dev)
    E[:n, :n] = Av[d]
    E[n:, n:] = torch.eye((d - 1) * n, dtype=dt, device=dev)
    for i in range(1, d + 1):
        A[:n, (i - 1) * n: i * n] = Av[d - i]
    A[n:, : (d - 1) * n] = -torch.eye((d - 1) * n, dtype=dt, device=dev)
    return E, -A


def _polyeig_pep(pep, dtype, eigsolvertype):
    E, A = companion(pep)
    D, V = eig_solve(eigsolvertype(A, E), target=1.0, nev=A.shape[0])
    return D, V[: pep.n, :]


def _polyeig_cheb(chebpep, dtype, eigsolvertype):
    """Colleague-matrix linearization in the Chebyshev basis."""
    k, n = chebpep.k, chebpep.n
    Fk = [_dense(F).to(torch.complex128) for F in chebpep.get_Av()]
    dev = Fk[0].device
    N = n * (k - 1)
    L0 = torch.zeros((N, N), dtype=torch.complex128, device=dev)
    L1 = torch.zeros((N, N), dtype=torch.complex128, device=dev)
    I = torch.eye(n, dtype=torch.complex128, device=dev)
    for j in range(1, k - 1):
        L0[(j - 1) * n: j * n, j * n: (j + 1) * n] = I
        L0[j * n: (j + 1) * n, (j - 1) * n: j * n] = I
    for j in range(1, k):
        L0[(k - 2) * n:, (j - 1) * n: j * n] = -Fk[j - 1]
    L0[(k - 2) * n:, (k - 3) * n: (k - 2) * n] += Fk[k - 1]
    for j in range(1, k - 1):
        L1[(j - 1) * n: j * n, (j - 1) * n: j * n] = (1.0 if j == 1
                                                        else 2.0) * I
    L1[(k - 2) * n:, (k - 2) * n:] = 2 * Fk[k - 1]
    D, V = lapack.geig(L0, L1)
    a, b = chebpep.a, chebpep.b
    V = V[:n, :]
    return (b - a) * (D + 1) / 2 + a, V / torch.linalg.vector_norm(
        V, dim=0, keepdim=True)


def polyeig(pep, dtype=None, eigsolvertype=DefaultEigSolver):
    """Solve a polynomial NEP by linearization: the colleague matrix for a
    ChebPEP, the companion pencil for a monomial PEP."""
    if isinstance(pep, ChebPEP):
        return _polyeig_cheb(pep, dtype, eigsolvertype)
    return _polyeig_pep(pep, dtype, eigsolvertype)
