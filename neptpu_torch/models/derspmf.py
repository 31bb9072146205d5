"""DerSPMF: an SPMF with a precomputed derivative table at a fixed shift
``sigma``: ``2m+2`` derivatives of each ``f_i`` at sigma (complex128, on the
host, by the bidiagonal matrix-function trick), so ``compute_Mlincomb`` at
sigma is one small GEMM and one fused bank apply - the shape IAR wants."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import matfun
from .spmf import AbstractSPMF, _bank_lincomb

__all__ = ["DerSPMF"]


class DerSPMF(AbstractSPMF):
    def __init__(self, spmf: AbstractSPMF, sigma, m: int):
        self.spmf = spmf
        self.sigma = complex(sigma)
        self.n = spmf.n
        k = 2 * m + 2
        # fD[j, i] = f_i^{(j)}(sigma)
        self.fD = torch.stack([matfun.fun_derivatives(f, self.sigma, k)
                               for f in spmf.get_fv()], dim=1)  # (2m+2, p)

    @property
    def bank(self):
        return self.spmf.bank

    @property
    def issparse(self):
        return self.spmf.issparse

    def get_Av(self):
        return self.spmf.get_Av()

    def get_fv(self):
        return self.spmf.get_fv()

    def Mder(self, lam, der: int = 0):
        return self.spmf.Mder(lam, der)

    def Mder_dense(self, lam, der: int = 0):
        return self.spmf.Mder_dense(lam, der)

    def MM(self, S, V):
        return self.spmf.MM(S, V)

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if complex(np.asarray(lam)) != self.sigma or startder != 0:
            return self.spmf.Mlincomb(lam, V, a=a, startder=startder)
        if V.ndim == 1:
            V = V[:, None]
        k = V.shape[1]
        if k > self.fD.shape[0]:
            return self.spmf.Mlincomb(lam, V, a=a, startder=startder)
        a = (torch.ones(k, dtype=torch.float64) if a is None
             else torch.as_tensor(a).cpu())
        # D[i, j] = a_j f_i^{(j)}(sigma): one GEMM, then the fused bank apply
        D = (a[:, None].to(self.fD.dtype) * self.fD[:k, :]).T
        if hasattr(self.spmf, "bank"):
            return _bank_lincomb(self.spmf.bank, V, D)
        z = None
        for j, A in enumerate(self.get_Av()):
            t = A @ (V.to(torch.promote_types(V.dtype, D.dtype))
                     @ D[j].to(V.device))
            z = t if z is None else z + t
        return z
