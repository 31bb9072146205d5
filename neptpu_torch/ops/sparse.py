"""Stacked operand storage for SPMF-form problems (plain PyTorch).

All terms of a bank share one storage layout and their values live in one
stacked tensor, so every solver need is one of three fused primitives:

* ``combine(w)``       -> sum_i w_i A_i         (assembly)
* ``lincomb_apply(W)`` -> sum_i A_i @ W[:, i]   (the compute_Mlincomb hot op)
* ``mm_apply(V, F)``   -> sum_i A_i (V @ F_i)   (block residual compute_MM)

Backends: ``DenseTermBank`` (stacked ``(m, n, n)``), ``SparseTermBank``
(aligned CSR: shared indices, stacked data — gather + index_add) and the
stacked-DIA ``DiaTermBank`` (``ops/dia.py``), which ``make_term_bank`` picks
for banded operand sets with few shared diagonals.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..config import resolve_device, to_numpy_dtype

__all__ = [
    "CSR",
    "DenseTermBank",
    "SparseTermBank",
    "make_term_bank",
    "spmv",
    "spmm",
]


def _to_scipy_csr(A):
    import scipy.sparse as sp

    if sp.issparse(A):
        return A.tocsr()
    return sp.csr_matrix(np.asarray(A))


def _fro(data, dims):
    return torch.sqrt(torch.sum(torch.abs(data) ** 2, dim=dims))


class CSR:
    """One CSR matrix over tensors; ``row_ids`` is the COO row per entry."""

    def __init__(self, data, indices, row_ids, indptr, shape):
        self.data = data
        self.indices = indices
        self.row_ids = row_ids
        self.indptr = indptr
        self.shape = tuple(shape)

    @property
    def nnz(self):
        return self.data.shape[-1]

    @property
    def dtype(self):
        return self.data.dtype

    def to_dense(self):
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.data.device)
        return out.index_put_((self.row_ids, self.indices), self.data,
                              accumulate=True)

    @classmethod
    def from_scipy(cls, A, dtype=None, device=None):
        """A CSR matrix on ``device`` (default: the card) from a scipy
        sparse matrix or an array (duplicates summed)."""
        from ..config import resolve_device, to_numpy_dtype

        device = resolve_device(device)
        A = _to_scipy_csr(A)
        A.sum_duplicates()
        data = np.asarray(A.data)
        if dtype is not None:
            data = data.astype(to_numpy_dtype(dtype))
        indptr = np.asarray(A.indptr, dtype=np.int64)
        row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                            np.diff(indptr))
        return cls(torch.as_tensor(data, device=device),
                   torch.as_tensor(A.indices.astype(np.int64), device=device),
                   torch.as_tensor(row_ids, device=device),
                   torch.as_tensor(indptr, device=device), A.shape)

    def matvec(self, x):
        return spmv(self, x)

    def matmat(self, X):
        return spmm(self, X)

    def __matmul__(self, x):
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)


def spmv(A: CSR, x):
    """``y = A @ x`` by gather + segment sum (``index_add_`` over the row of
    every stored entry)."""
    dt = torch.promote_types(x.dtype, A.dtype)
    prod = A.data.to(dt) * x.to(dt)[A.indices]
    y = torch.zeros(A.shape[0], dtype=dt, device=x.device)
    return y.index_add_(0, A.row_ids, prod)


def spmm(A: CSR, X):
    """``Y = A @ X`` for ``X (n, k)``, the same way as :func:`spmv`."""
    dt = torch.promote_types(X.dtype, A.dtype)
    prod = A.data.to(dt)[:, None] * X.to(dt)[A.indices, :]
    Y = torch.zeros((A.shape[0], X.shape[1]), dtype=dt, device=X.device)
    return Y.index_add_(0, A.row_ids, prod)


class DenseTermBank:
    """Stacked dense operands ``A`` of shape (m, n, n)."""

    is_sparse = False

    def __init__(self, A, fro_norms=None, host_A=None):
        self.A = A
        self.fro_norms = _fro(A, (1, 2)) if fro_norms is None else fro_norms
        self._host_A = host_A

    def host_csr_terms(self):
        import scipy.sparse as sp

        A = self._host_A if self._host_A is not None else self.A.cpu().numpy()
        return [sp.csr_matrix(A[i]) for i in range(A.shape[0])]

    @property
    def nterms(self):
        return self.A.shape[0]

    @property
    def n(self):
        return self.A.shape[1]

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def term_dense(self, i):
        return self.A[i]

    def term(self, i):
        return self.A[i]

    def combine(self, w):
        w = torch.as_tensor(w).to(self.A.device)
        dt = torch.promote_types(w.dtype, self.A.dtype)
        return torch.tensordot(w.to(dt), self.A.to(dt), dims=1)

    def lincomb_apply(self, W):
        dt = torch.promote_types(W.dtype, self.A.dtype)
        return torch.einsum("mij,jm->i", self.A.to(dt), W.to(dt))

    def lincomb_apply_mat(self, W):
        dt = torch.promote_types(W.dtype, self.A.dtype)
        return torch.einsum("mij,jkm->ik", self.A.to(dt), W.to(dt))

    def padded(self, p, eye_first=False):
        """The terms with ``p`` zero rows and columns appended (an identity
        on the first n rows first when ``eye_first``)."""
        n = self.n
        A = self.A
        if eye_first:
            A = torch.cat([torch.eye(n, dtype=A.dtype, device=A.device)[None],
                           A])
        return DenseTermBank(torch.nn.functional.pad(A, (0, p, 0, p)))

    def mm_apply(self, V, F):
        dt = torch.promote_types(torch.promote_types(V.dtype, F.dtype),
                                 self.A.dtype)
        VF = torch.einsum("nk,mkl->mnl", V.to(dt), F.to(dt).to(V.device))
        return torch.einsum("mij,mjl->il", self.A.to(dt), VF)


class SparseTermBank:
    """Aligned-pattern CSR bank: shared indices, stacked data (m, nnz)."""

    is_sparse = True

    def __init__(self, data, indices, row_ids, indptr, shape, fro_norms=None,
                 host=None):
        self.data = data
        self.indices = indices
        self.row_ids = row_ids
        self.indptr = indptr
        self.shape = tuple(shape)
        self.fro_norms = _fro(data, (1,)) if fro_norms is None else fro_norms
        self._host = host

    @property
    def nterms(self):
        return self.data.shape[0]

    @property
    def n(self):
        return self.shape[0]

    @property
    def nnz(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @classmethod
    def from_matrices(cls, mats: Sequence[Any], dtype=None, device=None):
        """Align the sparsity patterns of ``mats`` (scipy sparse / ndarray)."""
        import scipy.sparse as sp

        device = resolve_device(device)
        mats = [_to_scipy_csr(A) for A in mats]
        n, m = mats[0].shape
        pattern = sp.csr_matrix((n, m))
        for A in mats:
            P = A.copy()
            P.data = np.ones_like(P.data)
            pattern = pattern + P
        pattern = pattern.tocsr()
        pattern.sum_duplicates()
        pattern.sort_indices()
        nnz = pattern.nnz
        if dtype is None:
            dtype = np.result_type(*[A.dtype for A in mats])
        data = np.zeros((len(mats), nnz), dtype=to_numpy_dtype(dtype))
        indptr = pattern.indptr
        prow = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        pkeys = prow * m + pattern.indices.astype(np.int64)
        for i, A in enumerate(mats):
            A = A.tocsr()
            A.sum_duplicates()
            A.sort_indices()
            arow = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
            akeys = arow * m + A.indices.astype(np.int64)
            pos = np.searchsorted(pkeys, akeys)
            np.add.at(data[i], pos, A.data)
        indices = np.asarray(pattern.indices, dtype=np.int64)
        indptr = np.asarray(indptr, dtype=np.int64)
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        return cls(torch.from_numpy(data).to(device),
                   torch.from_numpy(indices).to(device),
                   torch.from_numpy(row_ids).to(device),
                   torch.from_numpy(indptr).to(device), (n, m),
                   host=(data, indices, indptr))

    def host_csr_terms(self):
        import scipy.sparse as sp

        if self._host is not None:
            data, indices, indptr = self._host
        else:
            data = self.data.cpu().numpy()
            indices = self.indices.cpu().numpy()
            indptr = self.indptr.cpu().numpy()
        # copies: consumers may mutate (eliminate_zeros etc.) and all terms
        # share one pattern
        return [sp.csr_matrix((data[i].copy(), indices.copy(), indptr.copy()),
                              shape=self.shape)
                for i in range(data.shape[0])]

    def padded(self, p, eye_first=False):
        """The terms with ``p`` zero rows and columns appended (an identity
        on the first n rows first when ``eye_first``), aligned anew."""
        import scipy.sparse as sp

        mats = self.host_csr_terms()
        if eye_first:
            mats = [sp.eye(self.n, format="csr")] + mats
        zero = sp.csr_matrix((p, p))
        return SparseTermBank.from_matrices(
            [sp.block_diag((A, zero), format="csr") for A in mats],
            dtype=self.dtype, device=self.device)

    def term_csr(self, i):
        """Term ``i`` as a :class:`CSR` on the bank's pattern."""
        return CSR(self.data[i], self.indices, self.row_ids, self.indptr,
                   self.shape)

    def term(self, i):
        return self.term_csr(i)

    def term_dense(self, i):
        return self.term_csr(i).to_dense()

    def combine(self, w):
        w = torch.as_tensor(w).to(self.data.device)
        dt = torch.promote_types(w.dtype, self.data.dtype)
        nz = torch.tensordot(w.to(dt), self.data.to(dt), dims=1)
        return CSR(nz, self.indices, self.row_ids, self.indptr, self.shape)

    def combine_dense(self, w):
        return self.combine(w).to_dense()

    def to_dense_bank(self):
        """The same terms as a :class:`DenseTermBank` on the bank's
        device."""
        A = torch.zeros((self.nterms,) + self.shape, dtype=self.dtype,
                        device=self.device)
        A[:, self.row_ids, self.indices] += self.data
        return DenseTermBank(A, self.fro_norms)

    def lincomb_apply(self, W):
        """``sum_i A_i @ W[:, i]``: one gather + elementwise + index_add."""
        dt = torch.promote_types(W.dtype, self.data.dtype)
        G = W.to(dt)[self.indices, :]  # (nnz, m)
        prod = torch.sum(G * self.data.to(dt).T, dim=1)
        y = torch.zeros(self.shape[0], dtype=dt, device=W.device)
        return y.index_add_(0, self.row_ids, prod)

    def lincomb_apply_mat(self, W):
        dt = torch.promote_types(W.dtype, self.data.dtype)
        G = W.to(dt)[self.indices]  # (nnz, k, m)
        prod = torch.einsum("nkm,mn->nk", G, self.data.to(dt))
        y = torch.zeros((self.shape[0], W.shape[1]), dtype=dt, device=W.device)
        return y.index_add_(0, self.row_ids, prod)

    def mm_apply(self, V, F):
        dt = torch.promote_types(torch.promote_types(V.dtype, F.dtype),
                                 self.data.dtype)
        VF = torch.einsum("nk,mkl->nlm", V.to(dt), F.to(dt).to(V.device))
        return self.lincomb_apply_mat(VF)


def make_term_bank(mats: Sequence[Any], dtype=None, prefer_sparse=None,
                   fmt=None, device=None):
    """Build the right term bank for a list of operands.

    ``prefer_sparse=None`` picks sparse storage iff all operands are
    scipy-sparse.  Among sparse formats, banded operand sets with few shared
    diagonals (<= 48, n >= 512) get the stacked-DIA layout; ``fmt`` forces
    "dia"/"csr"/"dense".  ``device=None`` is the card (``config``)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    seq = list(mats)
    if not seq:
        raise ValueError("term bank needs at least one operand")
    if prefer_sparse is None:
        prefer_sparse = all(sp.issparse(A) for A in seq)
    if fmt == "dense":
        prefer_sparse = False
    if prefer_sparse:
        from .dia import DiaTermBank

        if fmt == "dia":
            return DiaTermBank.from_matrices(seq, dtype=dtype, device=device)
        if fmt is None:
            n = seq[0].shape[0]
            offs = set()
            banded = True
            for A in seq:
                Ac = A.tocoo()
                d = np.unique(Ac.col.astype(np.int64) - Ac.row.astype(np.int64))
                if len(d) > 48:
                    banded = False
                    break
                offs.update(d.tolist())
            if banded and len(offs) <= 48 and n >= 512:
                return DiaTermBank.from_matrices(seq, dtype=dtype,
                                                 device=device)
        return SparseTermBank.from_matrices(seq, dtype=dtype, device=device)
    dense = [np.asarray(A.toarray() if sp.issparse(A) else A) for A in seq]
    if dtype is None:
        dtype = np.result_type(*[A.dtype for A in dense])
    A_host = np.stack([A.astype(to_numpy_dtype(dtype)) for A in dense])
    return DenseTermBank(torch.from_numpy(A_host).to(device), host_A=A_host)
