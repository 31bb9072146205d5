"""Projected NEPs ``N(lam) = W^H M(lam) V``.

For an SPMF the projection is again an SPMF with small dense operands
``B_i = W^H A_i V``.  The n-sized work stays on the original problem's
device: ``W``, ``V`` and the products ``A_i V`` through each term's
``matmat``.  The k x k operands (k <= ``maxsize``, 201 by default) live on
the host in complex128, as the Hessenberg matrices and Ritz values of the
Krylov solvers do, and the projected problem's compute functions run there;
``expand_projectmatrices`` is the rank-1 border update that Jacobi-Davidson
does once per outer iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import to_torch_dtype
from ..ops.sparse import DenseTermBank
from ..solvers.common import nep_device
from .spmf import AbstractSPMF, SPMF_NEP

__all__ = ["Proj_NEP", "Proj_SPMF_NEP", "create_proj_NEP",
           "set_projectmatrices", "expand_projectmatrices"]


def _apply_A(A, X):
    """``A @ X`` for a dense tensor or a term object with ``matmat``."""
    if isinstance(A, torch.Tensor):
        return A.to(torch.promote_types(A.dtype, X.dtype)) @ X
    return A.matmat(X)


class Proj_NEP(AbstractSPMF):
    pass


class Proj_SPMF_NEP(Proj_NEP):
    def __init__(self, orgnep: AbstractSPMF, maxsize: int = None,
                 dtype=np.complex128):
        if maxsize is None:
            maxsize = min(orgnep.n, 201)
        self.orgnep = orgnep
        self.orgnep_Av = orgnep.get_Av()
        self.orgnep_fv = orgnep.get_fv()
        self.device = nep_device(orgnep) or torch.device("cpu")
        m = len(self.orgnep_Av)
        self.B_mem = np.zeros((m, maxsize, maxsize), dtype=dtype)
        self.maxsize = maxsize
        self.k = 0
        tdt = to_torch_dtype(dtype)
        self.W = torch.zeros((orgnep.n, 0), dtype=tdt, device=self.device)
        self.V = torch.zeros((orgnep.n, 0), dtype=tdt, device=self.device)
        self.nep_proj = None
        self.n = 0

    def _basis(self, X):
        X = torch.as_tensor(X, device=self.device)
        return X.to(self.W.dtype)

    def _rebuild(self):
        k = self.k
        bank = DenseTermBank(torch.from_numpy(
            np.ascontiguousarray(self.B_mem[:, :k, :k])))
        self.nep_proj = SPMF_NEP(None, self.orgnep_fv, bank=bank,
                                 check_consistency=False)
        self.n = k

    def set_projectmatrices(self, W, V):
        W, V = self._basis(W), self._basis(V)
        k = V.shape[1]
        assert k <= self.maxsize, "projection exceeds preallocated memory"
        self.W, self.V = W, V
        Wh = W.conj().T
        for i, A in enumerate(self.orgnep_Av):
            self.B_mem[i, :k, :k] = (Wh @ _apply_A(A, V)).cpu().numpy()
        self.k = k
        self._rebuild()

    def expand_projectmatrices(self, Wnew, Vnew):
        """Rank-1 border update: ``Wnew``/``Vnew`` hold the old basis plus
        one new column each."""
        Wnew, Vnew = self._basis(Wnew), self._basis(Vnew)
        k = Vnew.shape[1] - 1
        assert k + 1 <= self.maxsize, "projection exceeds preallocated memory"
        w, v = Wnew[:, -1], Vnew[:, -1:]
        for i, A in enumerate(self.orgnep_Av):
            col = Wnew[:, :k].conj().T @ _apply_A(A, v)[:, 0]
            row = w.conj() @ _apply_A(A, Vnew[:, : k + 1])
            self.B_mem[i, :k, k] = col.cpu().numpy()
            self.B_mem[i, k, : k + 1] = row.cpu().numpy()
        self.W, self.V = Wnew, Vnew
        self.k = k + 1
        self._rebuild()

    # -- delegate compute functions ---------------------------------------
    @property
    def bank(self):
        """The projected operands' bank (on the host), once there is one."""
        return None if self.nep_proj is None else self.nep_proj.bank

    @property
    def issparse(self):
        return False

    def get_Av(self):
        return self.nep_proj.get_Av()

    def get_fv(self):
        return self.orgnep_fv

    def Mder(self, lam, der: int = 0):
        return self.nep_proj.Mder(lam, der)

    def Mder_dense(self, lam, der: int = 0):
        return self.nep_proj.Mder_dense(lam, der)

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return self.nep_proj.Mlincomb(lam, V, a=a, startder=startder)

    def MM(self, S, V):
        return self.nep_proj.MM(S, V)


def create_proj_NEP(orgnep, maxsize: int = None, dtype=np.complex128):
    if isinstance(orgnep, AbstractSPMF):
        return Proj_SPMF_NEP(orgnep, maxsize, dtype)
    raise NotImplementedError(
        "create_proj_NEP requires an AbstractSPMF (a projectable NEP)")


def set_projectmatrices(proj_nep, W, V):
    """Module-level form of :meth:`Proj_SPMF_NEP.set_projectmatrices`."""
    return proj_nep.set_projectmatrices(W, V)


def expand_projectmatrices(proj_nep, Wnew, Vnew):
    """Module-level form of :meth:`Proj_SPMF_NEP.expand_projectmatrices`."""
    return proj_nep.expand_projectmatrices(Wnew, Vnew)
