"""The rational-Krylov view of a problem for NLEIGS: whether it is an SPMF,
whether it splits as ``SPMFSumNEP(PEP, S)``, and whether its nonlinear part
is low rank.

Weighted operator sums ``sum_i c_i A_i x`` go through the problem's term
banks, one fused apply per bank (:func:`apply_terms`): on a stacked-DIA
bank with a complex operand that is one launch of the re/im pair kernel."""
from __future__ import annotations

import numpy as np
import torch

from ...models.lowrank import LowRankFactorizedNEP
from ...models.pep import PEP
from ...models.spmf import AbstractSPMF, SPMF_NEP, _bank_lincomb
from ...models.sumnep import SPMFSumNEP

__all__ = ["RKNEP", "get_rk_nep", "term_banks", "apply_terms"]


def term_banks(nep):
    """The term banks that hold ``nep.get_Av()`` in order (a sum's parts
    one after the other), or ``None`` when a part keeps terms outside a
    bank (a delay problem's ``-lam I``, a problem given by callbacks)."""
    if isinstance(nep, SPMFSumNEP):
        a, b = term_banks(nep.nep1), term_banks(nep.nep2)
        return None if a is None or b is None else a + b
    if isinstance(nep, (SPMF_NEP, PEP)):
        return [nep.bank]
    return None


def apply_one(A, x):
    """``A @ x`` for a dense tensor or a term object with ``matvec``."""
    return A @ x if isinstance(A, torch.Tensor) else A.matvec(x)


def apply_terms(nep, WT, banks=None, Av=None):
    """``sum_i A_i @ WT[i]`` over the terms of ``nep`` for a term-major
    operand ``WT (m, n)``: one fused apply per term bank, else (``banks``
    None) a loop over the terms ``Av``."""
    if banks is None:
        banks = term_banks(nep)
    if banks is None:
        Av = nep.get_Av() if Av is None else Av
        return sum(apply_one(A, WT[i]) for i, A in enumerate(Av))
    y, s = None, 0
    for bank in banks:
        W = WT[s: s + bank.nterms]
        t = (bank.lincomb_apply_t(W) if hasattr(bank, "lincomb_apply_t")
             else bank.lincomb_apply(W.T))
        y = t if y is None else y + t
        s += bank.nterms
    return y


def _dense(A):
    return A if isinstance(A, torch.Tensor) else A.to_dense()


class RKNEP:
    def __init__(self, nep, spmf=False, p=0, q=0, is_low_rank=False, r=0,
                 L=None, U=None):
        self.nep = nep
        self.spmf = spmf
        self.p = p
        self.q = q
        self.is_low_rank = is_low_rank
        self.r = r
        self.L = L or []
        self.U = U or []
        if is_low_rank:
            # the compacted low-rank factors: UU drives the r-sized tail
            # recurrences, LL applies the tail divided differences
            # D_nb = hcat_i(sgdd[p+1+i, nb] L_i) as ONE n x r matrix and
            # per-degree scalar weights (memory O(n r) whatever the degree)
            self.UU = torch.cat(list(self.U), dim=1)
            self.LL = torch.cat(list(self.L), dim=1)
            self._ri = np.array([Li.shape[1] for Li in self.L])
        else:
            self.UU = None
            self.LL = None
        self._Av = nep.get_Av() if spmf else None
        self._banks = term_banks(nep) if spmf else None

    def apply_tail(self, sgdd, nb, z):
        """Matrix-free tail divided difference ``D_nb @ z`` for nb > p
        through the compacted LL and the per-term scalar weights; ``z`` is
        the r-sized tail block."""
        w = np.repeat(np.asarray(sgdd)[self.p + 1: self.p + 1 + self.q, nb],
                      self._ri)
        return self.LL.to(z.dtype) @ (
            torch.as_tensor(w, device=z.device).to(z.dtype) * z)

    def apply_weighted(self, coeffs, x):
        """``sum_i coeffs[i] * (Av[i] @ x)`` over the whole ``get_Av`` list:
        ``_bank_lincomb(bank, x[:, None], c[:, None])`` for each term bank
        (one fused apply each), else a loop over the terms."""
        c = torch.as_tensor(np.asarray(coeffs, dtype=complex),
                            device=x.device)
        if self._banks is None:
            return apply_terms(self.nep, c[:, None] * x[None, :],
                               Av=self._Av)
        y, s = None, 0
        for bank in self._banks:
            t = _bank_lincomb(bank, x[:, None], c[s: s + bank.nterms, None])
            y = t if y is None else y + t
            s += bank.nterms
        return y

    def construct_D(self, nb, sgdd):
        """Explicit divided difference: the full n x n matrix for nb <= p;
        for the low-rank tail (nb > p) the compact n x r matrix
        ``hcat_i(sgdd[p+1+i, nb] L_i)``."""
        if self.is_low_rank and nb > self.p:
            return torch.cat([complex(sgdd[self.p + 1 + i, nb]) * self.L[i]
                              for i in range(self.q)], dim=1)
        D = None
        for i, A in enumerate(self._Av):
            t = complex(sgdd[i, nb]) * _dense(A)
            D = t if D is None else D + t
        return D


def get_rk_nep(nep):
    if not isinstance(nep, AbstractSPMF):
        return RKNEP(nep, spmf=False)
    Av = nep.get_Av()
    if isinstance(nep, PEP):
        return RKNEP(nep, spmf=True, p=len(Av) - 1, q=0)
    if isinstance(nep, SPMFSumNEP) and isinstance(nep.nep1, PEP):
        p = len(nep.nep1.get_Av()) - 1
        q = len(nep.nep2.get_Av())
        if q > 0 and isinstance(nep.nep2, LowRankFactorizedNEP):
            return RKNEP(nep, spmf=True, p=p, q=q, is_low_rank=True,
                         r=nep.nep2.r, L=list(nep.nep2.L),
                         U=list(nep.nep2.U))
        return RKNEP(nep, spmf=True, p=p, q=q)
    return RKNEP(nep, spmf=True, p=-1, q=len(Av))
