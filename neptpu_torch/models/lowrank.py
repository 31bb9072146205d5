"""Low-rank terms ``A_i = L_i U_i^H`` kept as their factors.

* ``low_rank_factors`` compacts a boundary-supported sparse matrix into its
  factors (host numpy);
* ``LowRankTerm`` is one such term on the device: ``matvec``/``matmat`` are
  two skinny GEMMs, ``to_dense`` forms ``L @ U^H`` only on demand;
* ``LowRankTermBank`` stacks the factors of all terms (``Lcat (n, R)``,
  ``Ucat (n, R)``, the term of each rank column in ``tidx``) and offers the
  term-bank primitives, so the fused apply ``sum_i L_i U_i^H W[:, i]`` is one
  gather-reduce and one GEMM, as for the waveguide's boundary terms
  (``ops/mixed.py``);
* ``LowRankFactorizedNEP`` is the SPMF over such a bank.

The JAX package materializes every term as the dense product ``L @ U^H``; the
port keeps the factors and computes the same numbers up to rounding order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.mixed import MixedTermBank
from .spmf import SPMF_NEP

__all__ = ["low_rank_factors", "LowRankTerm", "LowRankTermBank",
           "LowRankMatrixAndFunction", "LowRankFactorizedNEP"]


def low_rank_factors(A, tol=None):
    """Compact factors ``A = L @ U^H`` of a (sparse) matrix whose nonzeros
    live in a small set of rows/columns: an SVD of the compacted nonzero
    block (exact for scattered supports).  Host numpy; returns ``(L, U)``."""
    import scipy.sparse as sp

    if sp.issparse(A):
        Ac = A.tocoo()
        n, m = Ac.shape
        if Ac.nnz == 0:
            return np.zeros((n, 0)), np.zeros((m, 0))
        urows = np.unique(Ac.row)
        ucols = np.unique(Ac.col)
        B = np.asarray(Ac.tocsr()[urows][:, ucols].toarray())
    else:
        B = np.asarray(A)
        n, m = B.shape
        urows = np.arange(n)
        ucols = np.arange(m)
    Us, s, Vh = np.linalg.svd(B, full_matrices=False)
    if tol is None:
        tol = max(B.shape) * np.finfo(s.dtype).eps * (s[0] if s.size else 0.0)
    r = int(np.sum(s > tol))
    L = np.zeros((n, r), dtype=B.dtype)
    U = np.zeros((m, r), dtype=B.dtype)
    L[urows] = Us[:, :r] * s[:r]
    U[ucols] = Vh[:r].conj().T
    return L, U


def _fro_lowrank(L, U):
    """``||L U^H||_F`` from the r x r Gram matrices, without the n x n
    product."""
    G = (U.conj().T @ U) * (L.conj().T @ L).T
    return torch.sqrt(torch.clamp(torch.sum(G).real, min=0.0))


class LowRankTerm:
    """One term ``L @ U^H`` (``L``, ``U``: tensors of shape ``(n, r)``)."""

    def __init__(self, L, U):
        self.L, self.U = L, U
        self.shape = (L.shape[0], U.shape[0])

    @property
    def dtype(self):
        return torch.promote_types(self.L.dtype, self.U.dtype)

    @property
    def fro_norm(self):
        return float(_fro_lowrank(self.L, self.U))

    def matmat(self, X):
        dt = torch.promote_types(self.dtype, X.dtype)
        return self.L.to(dt) @ (self.U.to(dt).conj().T @ X.to(dt))

    def matvec(self, x):
        return self.matmat(x[:, None])[:, 0]

    def __matmul__(self, x):
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    def to_dense(self):
        return self.L.to(self.dtype) @ self.U.to(self.dtype).conj().T


class LowRankTermBank:
    """The term-bank primitives over stacked low-rank factors: term ``i`` is
    ``Lcat[:, sel] @ Ucat[:, sel]^H`` over the rank columns ``sel`` with
    ``tidx == i``."""

    is_sparse = False

    def __init__(self, L, U):
        self.Lcat = torch.cat(L, dim=1)
        self.Ucat = torch.cat(U, dim=1)
        self.tidx = tuple(i for i, Li in enumerate(L)
                          for _ in range(Li.shape[1]))
        self._tidx = torch.tensor(self.tidx, dtype=torch.int64,
                                  device=self.device)
        self._terms = [LowRankTerm(Li, Ui) for Li, Ui in zip(L, U)]
        self.fro_norms = torch.stack(
            [_fro_lowrank(Li, Ui) for Li, Ui in zip(L, U)]).cpu()

    @property
    def nterms(self):
        return len(self._terms)

    @property
    def n(self):
        return self.Lcat.shape[0]

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.Lcat.dtype

    @property
    def device(self):
        return self.Lcat.device

    def term(self, i):
        return self._terms[i]

    def combine(self, w):
        """``sum_i w_i A_i`` as one low-rank term."""
        w = torch.as_tensor(w).to(self.device)
        dt = torch.promote_types(w.dtype, self.dtype)
        return LowRankTerm(self.Lcat.to(dt) * w.to(dt)[self._tidx],
                           self.Ucat.to(dt))

    def lincomb_apply_t(self, WT):
        """``sum_i A_i @ WT[i]`` for a term-major operand ``WT (m, n)``: the
        gather-reduce of the mixed bank's low-rank groups, then one GEMM."""
        dt = torch.promote_types(WT.dtype, self.dtype)
        return MixedTermBank._group_apply(self.Lcat.to(dt),
                                          self.Ucat.to(dt).conj(), self._tidx,
                                          WT.to(dt))

    def lincomb_apply(self, W):
        return self.lincomb_apply_t(W.T)

    def mm_apply(self, V, F):
        """``sum_i A_i (V @ F_i)`` with F stacked ``(m, k, k)``."""
        dt = torch.promote_types(torch.promote_types(V.dtype, F.dtype),
                                 self.dtype)
        UhV = self.Ucat.to(dt).conj().T @ V.to(dt)  # (R, k)
        G = torch.einsum("rk,rkl->rl", UhV, F.to(dt).to(V.device)[self._tidx])
        return self.Lcat.to(dt) @ G


class LowRankMatrixAndFunction:
    """One low-rank term ``(A = L U^H, f)``.  Either pass the factors ``L``
    and ``U``, or just ``A`` and its compact factors are computed from its
    nonzero support."""

    def __init__(self, A, f, L=None, U=None):
        if L is None or U is None:
            L, U = low_rank_factors(A)
        self.A = A
        self.L = L
        self.U = U
        self.f = f


def _factor(X, device):
    import scipy.sparse as sp

    if isinstance(X, torch.Tensor):
        return X.to(device)
    if sp.issparse(X):
        X = X.toarray()
    return torch.as_tensor(np.asarray(X), device=device)


class LowRankFactorizedNEP(SPMF_NEP):
    """SPMF ``sum_i L_i U_i^H f_i(lam)`` over a :class:`LowRankTermBank`.

    ``L``, ``U``: lists of ``(n, r_i)`` factors (numpy, scipy or tensors);
    ``device``: where the factors live (default: that of tensor factors,
    else the card).  ``A`` is accepted for the JAX package's signature and
    not stored: the factors are the operands."""

    def __init__(self, L, U, f, A=None, device=None):
        like = next((X for X in list(L) + list(U)
                     if isinstance(X, torch.Tensor)), None)
        device = resolve_device(device, like=like)
        L = [_factor(Li, device) for Li in L]
        U = [_factor(Ui, device) for Ui in U]
        self.L, self.U = L, U
        self.r = sum(Ui.shape[1] for Ui in U)
        super().__init__(None, f, bank=LowRankTermBank(L, U),
                         check_consistency=False)

    @classmethod
    def from_amf(cls, amf, device=None):
        """Build from a list of :class:`LowRankMatrixAndFunction`."""
        return cls([m.L for m in amf], [m.U for m in amf],
                   [m.f for m in amf], device=device)
