"""Delay eigenvalue problem  M(lam) = -lam*I + sum_i A_i exp(-tau_i lam).

Fast paths avoid matrix functions entirely: derivative weights are the closed
forms ``(-tau_i)^j exp(-tau_i lam)``, so ``compute_Mlincomb`` is a tiny
coefficient GEMM followed by ONE fused multi-term apply of the term bank (the
DIA SpMV kernel on the card for a banded problem).  The coefficient table is
computed on the host in float64/complex128 (it is ``nterms x k``); the delays
``tauv`` are a host numpy array.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import complex_of, real_of
from ..ops import matfun
from ..ops.sparse import CSR, make_term_bank
from .spmf import AbstractSPMF, _bank_lincomb

__all__ = ["DEP"]


def _host(x):
    """A host numpy value from a tensor, array or Python scalar."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class DEP(AbstractSPMF):
    """``A``: n x n matrices (scipy-sparse or array-like), one per delay in
    ``tauv``; ``device``: where the term bank lives (default: the card)."""

    def __init__(self, A: Sequence, tauv=(0.0, 1.0), dtype=None, bank=None,
                 device=None):
        if bank is None:
            bank = make_term_bank(A, dtype=dtype, device=device)
        self.bank = bank
        if np.iscomplexobj(_host(tauv)):
            raise ValueError("The delays need to be real.")
        tau = np.asarray(_host(tauv), dtype=float)
        if tau.shape[0] != bank.nterms:
            raise ValueError("one delay per matrix required")
        self.tauv = tau
        self.n = bank.n

    @property
    def issparse(self):
        return self.bank.is_sparse

    # -- SPMF view: the -lam*I term comes first ----------------------------
    def get_Av(self):
        b = self.bank
        if b.is_sparse:
            idx = torch.arange(self.n, device=b.device)
            eye = CSR(torch.ones(self.n, dtype=b.dtype, device=b.device), idx,
                      idx, torch.arange(self.n + 1, device=b.device),
                      (self.n, self.n))
        else:
            eye = torch.eye(self.n, dtype=b.dtype, device=b.device)
        return [eye] + [b.term(i) for i in range(b.nterms)]

    def get_fv(self):
        fv = [lambda S: -S]
        for tau in self.tauv:
            if tau == 0:
                fv.append(matfun.eye_like)
            else:
                fv.append(lambda S, t=float(tau): matfun.expm(-t * S))
        return fv

    # -- compute functions -------------------------------------------------
    def _exp_coeffs(self, lam, k: int, a, startder: int):
        """``C[i, j] = a_j * (-tau_i)^(j+startder) * exp(-tau_i*lam)`` on the
        host: float64 when ``lam`` and ``a`` are real, else complex128."""
        lam, a = _host(lam)[()], _host(a)
        tau = self.tauv
        j = np.arange(startder, startder + k)
        # (-tau)^j with 0^0 = 1 at a zero delay
        pw = np.where((tau[:, None] == 0) & (j[None, :] == 0), 1.0,
                      (-tau[:, None]) ** j[None, :])
        # far outside a solver's basin exp overflows: the inf/nan travels to
        # the error measure and surfaces as non-convergence, not a warning
        with np.errstate(over="ignore", invalid="ignore"):
            return a[None, :] * pw * np.exp(-tau[:, None] * lam)

    def _table(self, C, like_dtype):
        """The host table as a tensor on the bank's device, real or complex
        in the precision of ``like_dtype``."""
        dt = (complex_of(like_dtype) if np.iscomplexobj(C)
              else real_of(like_dtype))
        return torch.as_tensor(C, dtype=dt, device=self.bank.device)

    def Mder(self, lam, der: int = 0):
        lam = _host(lam)[()]
        w = self._table(self._exp_coeffs(lam, 1, np.ones(1), der)[:, 0],
                        self.bank.dtype)
        M = self.bank.combine(w)
        # a sparse combination is densified only where the -lam*I / -I
        # correction applies (the identity may be outside its pattern)
        if der > 1:
            return M
        if not isinstance(M, torch.Tensor):
            M = M.to_dense()
        lam_t = self._table(np.asarray(lam), self.bank.dtype)
        M = M.to(torch.promote_types(M.dtype, lam_t.dtype))
        eye = torch.eye(self.n, dtype=M.dtype, device=M.device)
        return M - (lam_t * eye if der == 0 else eye)

    def Mder_dense(self, lam, der: int = 0):
        M = self.Mder(lam, der)
        return M if isinstance(M, torch.Tensor) else M.to_dense()

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if V.ndim == 1:
            V = V[:, None]
        k = V.shape[1]
        a = np.ones(k) if a is None else _host(a)
        lam = _host(lam)[()]
        like = torch.promote_types(V.dtype, self.bank.dtype)
        C = self._table(self._exp_coeffs(lam, k, a, startder), like)  # (m, k)
        y = _bank_lincomb(self.bank, V, C)
        # the -lam*I term contributes only at derivative orders 0 and 1
        if startder == 0:
            corr = [a[0] * lam] + ([a[1]] if k > 1 else [])
        else:
            corr = [a[0]] if startder == 1 else []
        for j, c in enumerate(corr):
            y = y - np.asarray(c).item() * V[:, j]
        return y

    def MM(self, S, V):
        dt = torch.promote_types(torch.promote_types(S.dtype, V.dtype),
                                 self.bank.dtype)
        S = S.to(dt)
        F = torch.stack([matfun.expm(-float(t) * S) for t in self.tauv])
        return self.bank.mm_apply(V, F) - V.to(dt) @ S.to(V.device)
