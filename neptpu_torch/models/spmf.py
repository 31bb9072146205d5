"""SPMF: sum of products of matrices and functions, M(lam) = sum_i A_i f_i(lam).

The operands live in a term bank (``ops/sparse.py``, ``ops/dia.py``), so

* ``compute_Mder`` is one weight contraction over the stacked values,
* ``compute_Mlincomb`` is a small derivative-table GEMM + ONE fused
  multi-term apply (the DIA SpMV kernel on the card),
* ``compute_MM`` evaluates each ``f_i`` on the small dense S and does a
  batched SpMM.

Term functions follow the matrix-function contract of ``ops/matfun.py``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..core.nep import NEP
from ..ops import matfun
from ..ops.sparse import make_term_bank

__all__ = ["AbstractSPMF", "SPMF_NEP", "fun_scalar"]


def fun_scalar(f, lam):
    """Evaluate a matrix-function term at a scalar via a 1x1 matrix."""
    S = torch.as_tensor(complex(lam), dtype=torch.complex128).reshape(1, 1)
    return f(S)[0, 0]


def _check_fv_consistency(fv):
    """Each ``f_i`` must map a small dense matrix to one of the same shape —
    a wrong-shaped term function fails here with a clear error."""
    S = torch.tensor([[0.31 + 0.11j, 0.02], [0.0, 0.37 + 0.13j]],
                     dtype=torch.complex128)
    for i, f in enumerate(fv):
        try:
            out = f(S)
        except Exception:  # cannot probe (dtype-restricted function); trust it
            continue
        shape = tuple(getattr(out, "shape", ()))
        if shape != tuple(S.shape):
            raise ValueError(
                f"SPMF term function fv[{i}] is not a matrix function: "
                f"f(2x2 matrix) returned shape {shape}, expected (2, 2). "
                "Term functions must map k x k matrices to k x k matrices "
                "(use neptpu_torch.ops.matfun primitives).")


def _bank_lincomb(bank, V, D):
    """``sum_i A_i (V @ D[i])`` for the term weights ``D (m, k)``: the
    operand formed term-major, ``D @ V^T (m, n)``, for a bank that takes it so
    (the DIA kernel's layout, no transpose copy), else row-major
    ``V @ D^T (n, m)`` - the same GEMM either way."""
    dt = torch.promote_types(V.dtype, D.dtype)
    V, D = V.to(dt), D.to(device=V.device, dtype=dt)
    if hasattr(bank, "lincomb_apply_t"):
        return bank.lincomb_apply_t(D @ V.T)
    return bank.lincomb_apply(V @ D.T)


class AbstractSPMF(NEP):
    """Interface: ``get_Av()`` operand list, ``get_fv()`` matrix functions."""

    def get_Av(self):
        raise NotImplementedError

    def get_fv(self):
        raise NotImplementedError

    def fv_scalar(self, lam):
        """Vector ``[f_i(lam)]`` of scalar term values."""
        return torch.stack([fun_scalar(f, lam) for f in self.get_fv()])


class SPMF_NEP(AbstractSPMF):
    """Concrete SPMF over a term bank.

    ``Av``: n x n matrices (scipy-sparse or array-like); ``fv``: matrix
    functions built from ``neptpu_torch.ops.matfun`` primitives;
    ``align_sparsity_patterns``: kept for API parity, as in the JAX package
    (alignment is the storage whenever all operands are sparse); ``device``:
    where the bank lives."""

    def __init__(self, Av: Sequence, fv: Sequence[Callable], dtype=None,
                 align_sparsity_patterns: bool = True, bank=None,
                 check_consistency: bool = True, device=None):
        if bank is None:
            bank = make_term_bank(Av, dtype=dtype, device=device)
        self.bank = bank
        self.fv = list(fv)
        if len(self.fv) != bank.nterms:
            raise ValueError(
                f"got {bank.nterms} matrices but {len(self.fv)} functions")
        if check_consistency:
            _check_fv_consistency(self.fv)
        self.n = bank.n

    @property
    def issparse(self):
        return self.bank.is_sparse

    def get_Av(self):
        return [self.bank.term(i) for i in range(self.bank.nterms)]

    def get_fv(self):
        return self.fv

    def Mder(self, lam, der: int = 0):
        w = torch.stack([matfun.fun_derivatives(f, lam, der + 1)[der]
                         for f in self.fv])
        return self.bank.combine(w)

    def Mder_dense(self, lam, der: int = 0):
        M = self.Mder(lam, der)
        return M if isinstance(M, torch.Tensor) else M.to_dense()

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if V.ndim == 1:
            V = V[:, None]
        if a is None:
            a = torch.ones(V.shape[1], dtype=torch.float64)
        D = matfun.deriv_table(self.fv, lam, a, startder=startder)  # (m, k)
        return _bank_lincomb(self.bank, V, D)

    def MM(self, S, V):
        S = S.to(torch.promote_types(S.dtype, torch.float32))
        F = torch.stack([f(S) for f in self.fv])
        return self.bank.mm_apply(V, F)
