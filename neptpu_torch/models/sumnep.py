"""Sums of NEPs: ``SPMFSumNEP`` keeps SPMF-ness by concatenating the term
lists (this is how gun = PEP + sqrt-SPMF is expressed); ``GenericSumNEP``
adds compute-function results."""
from __future__ import annotations

import torch

from ..core.nep import NEP, compute_Mder, compute_Mlincomb, compute_MM
from .spmf import AbstractSPMF

__all__ = ["SumNEP", "GenericSumNEP", "SPMFSumNEP"]


def _add(M1, M2):
    d1 = M1 if isinstance(M1, torch.Tensor) else M1.to_dense()
    d2 = M2 if isinstance(M2, torch.Tensor) else M2.to_dense()
    return d1 + d2


class _SumMixin:
    def Mder(self, lam, der: int = 0):
        return _add(compute_Mder(self.nep1, lam, der),
                    compute_Mder(self.nep2, lam, der))

    Mder_dense = Mder

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return (compute_Mlincomb(self.nep1, lam, V, a, startder)
                + compute_Mlincomb(self.nep2, lam, V, a, startder))

    def MM(self, S, V):
        return compute_MM(self.nep1, S, V) + compute_MM(self.nep2, S, V)


class GenericSumNEP(_SumMixin, NEP):
    def __init__(self, nep1: NEP, nep2: NEP):
        if nep1.n != nep2.n:
            raise ValueError(f"sizes differ: {nep1.n} != {nep2.n}")
        self.nep1, self.nep2 = nep1, nep2
        self.n = nep1.n


class SPMFSumNEP(_SumMixin, AbstractSPMF):
    def __init__(self, nep1: AbstractSPMF, nep2: AbstractSPMF):
        if nep1.n != nep2.n:
            raise ValueError(f"sizes differ: {nep1.n} != {nep2.n}")
        self.nep1, self.nep2 = nep1, nep2
        self.n = nep1.n

    @property
    def issparse(self):
        return self.nep1.issparse and self.nep2.issparse

    def get_Av(self):
        return list(self.nep1.get_Av()) + list(self.nep2.get_Av())

    def get_fv(self):
        return list(self.nep1.get_fv()) + list(self.nep2.get_fv())


def SumNEP(nep1: NEP, nep2: NEP):
    """SPMF + SPMF stays SPMF."""
    if isinstance(nep1, AbstractSPMF) and isinstance(nep2, AbstractSPMF):
        return SPMFSumNEP(nep1, nep2)
    return GenericSumNEP(nep1, nep2)
