"""Polynomial eigenvalue problem  M(lam) = sum_d A_d lam^d.

Closed-form monomial derivative weights: ``compute_Mlincomb`` is a small
coefficient GEMM + one fused multi-term SpMV over the term bank.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..ops import matfun
from ..ops.sparse import make_term_bank
from .spmf import AbstractSPMF, _bank_lincomb

__all__ = ["PEP", "interpolate_pep"]


def _falling(d: int, j: int) -> float:
    """d!/(d-j)! (0 when j > d)."""
    if j > d:
        return 0.0
    return float(math.factorial(d) // math.factorial(d - j))


def _monomial(d):
    def f(S):
        if d == 0:
            return torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
        return torch.linalg.matrix_power(S, d)

    def derivs(lam, k):
        out = np.zeros(k, dtype=complex)
        for j in range(min(k, d + 1)):
            out[j] = _falling(d, j) * lam ** (d - j)
        return out

    return matfun.with_derivs(f, derivs)


class PEP(AbstractSPMF):
    def __init__(self, A: Sequence, dtype=None, bank=None, device=None):
        if bank is None:
            bank = make_term_bank(A, dtype=dtype, device=device)
        self.bank = bank
        self.n = bank.n
        self.degree = bank.nterms - 1

    @property
    def issparse(self):
        return self.bank.is_sparse

    def get_Av(self):
        return [self.bank.term(i) for i in range(self.bank.nterms)]

    def get_fv(self):
        return [_monomial(d) for d in range(self.degree + 1)]

    def _coeffs(self, lam, k: int, a, startder: int):
        """``C[d, j] = a_j * d!/(d-j-sd)! * lam^(d-j-sd)`` (complex128, CPU)."""
        lam = complex(lam)
        a = np.asarray(a, dtype=complex)
        C = np.zeros((self.degree + 1, k), dtype=complex)
        for d in range(self.degree + 1):
            for j in range(k):
                e = d - j - startder
                c = _falling(d, j + startder)
                if e >= 0 and c != 0.0:
                    C[d, j] = a[j] * c * lam**e
        return torch.from_numpy(C)

    def Mder(self, lam, der: int = 0):
        return self.bank.combine(self._coeffs(lam, 1, [1.0], der)[:, 0])

    def Mder_dense(self, lam, der: int = 0):
        M = self.Mder(lam, der)
        return M if isinstance(M, torch.Tensor) else M.to_dense()

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if V.ndim == 1:
            V = V[:, None]
        k = V.shape[1]
        if a is None:
            a = np.ones(k)
        C = self._coeffs(lam, k, np.asarray(a), startder)  # (deg+1, k)
        return _bank_lincomb(self.bank, V, C)

    def MM(self, S, V):
        """``sum_d A_d V S^d`` via the power recurrence."""
        dt = torch.promote_types(torch.promote_types(S.dtype, V.dtype),
                                 self.bank.dtype)
        S = S.to(dt)
        P = torch.eye(S.shape[0], dtype=dt, device=S.device)
        F = [P]
        for _ in range(self.degree):
            P = P @ S
            F.append(P)
        return self.bank.mm_apply(V, torch.stack(F))


def interpolate_pep(nep, points, device=None):
    """Interpolate any NEP at ``points`` into a PEP of degree
    ``len(points) - 1``: the Vandermonde system solved entrywise over the
    stacked ``Mder(lam_j)`` (on the host, complex128; a real result where
    every coefficient is real).  ``device``: where the PEP's bank lives
    (default: the original problem's device, else the card)."""
    from ..solvers.common import nep_device

    if device is None:
        device = nep_device(nep)
    pts = np.asarray(points)
    d = len(pts) - 1
    Ms = []
    for p in pts:
        M = nep.Mder_dense(p) if hasattr(nep, "Mder_dense") else nep.Mder(p)
        M = M if isinstance(M, torch.Tensor) else M.to_dense()
        Ms.append(M.detach().cpu().numpy())
    V = np.vander(pts, d + 1, increasing=True)  # (d+1, d+1)
    stacked = np.stack([M.reshape(-1) for M in Ms])  # (d+1, n*n)
    coeffs = np.linalg.solve(V, stacked)
    n = Ms[0].shape[0]
    A = [coeffs[i].reshape(n, n) for i in range(d + 1)]
    if not any(np.iscomplexobj(a) and np.abs(a.imag).max() > 0 for a in A):
        A = [a.real for a in A]
    return PEP(A, device=device)
