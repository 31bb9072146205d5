"""Mixed term bank: banded/dense real main part + stacked low-rank terms
(complex allowed), with a split re/im apply for the complex-as-real scan.

The gun-class SPMF couples large banded operands (K, M) with boundary
matrices (W1, W2) whose nonzeros live in a tiny row/column box.  The bank is

* a streaming DIA (or CSR/dense) bank for the real main terms,
* ALL low-rank factors stacked into four matrices (re/im x left/right), so
  every boundary term is applied by one gather + reduce + GEMV per group:
  ``y += L @ einsum('nr,nr->r', U, W[:, tidx])``.

Complex operands never enter the bank as complex: ``A = Ar + i Ai`` rides as
real factor pairs and the split apply carries the cross terms
(``yre = Ar wre - Ai wim``, ``yim = Ar wim + Ai wre``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, to_numpy_dtype, to_torch_dtype

__all__ = ["MixedTermBank", "make_mixed_bank"]


class MixedTermBank:
    """Terms split into a real main bank (original indices ``main_idx``) and
    stacked low-rank factors: real parts ``(Lr, Ur, tidx_r)``, imaginary parts
    ``(Li, Ui, tidx_i)``, term j's real part being ``Lr[:, sel] Ur[:, sel]^T``
    over the ranks ``sel`` with ``tidx_r == j``.  ``lincomb_apply(W)``
    computes ``sum_i A_i W[:, i]`` in the ORIGINAL term order;
    ``lincomb_apply_split_t`` is the re/im pair form used by the scan, on
    term-major channels ``(nterms, n)`` as the scan holds them, and
    ``lincomb_apply_split`` the same for row-major ``(n, nterms)``."""

    is_sparse = True

    def __init__(self, inner, Lr, Ur, Li, Ui, main_idx, tidx_r, tidx_i,
                 shape, nterms, fro_norms):
        self.inner = inner
        self.Lr, self.Ur = Lr, Ur
        self.Li, self.Ui = Li, Ui
        self.main_idx = tuple(int(i) for i in main_idx)
        self.tidx_r = tuple(int(i) for i in tidx_r)
        self.tidx_i = tuple(int(i) for i in tidx_i)
        self.shape = tuple(shape)
        self._nterms = int(nterms)
        self.fro_norms = fro_norms
        dev = self.device
        # term selections, built once: the main terms as a slice where they
        # are consecutive (a view of a term-major operand, no gather launch),
        # else as a device index tensor
        lo = self.main_idx[0]
        if self.main_idx == tuple(range(lo, lo + len(self.main_idx))):
            self._sel = slice(lo, lo + len(self.main_idx))
        else:
            self._sel = torch.tensor(self.main_idx, dtype=torch.int64,
                                     device=dev)
        self._tr = torch.tensor(self.tidx_r, dtype=torch.int64, device=dev)
        self._ti = torch.tensor(self.tidx_i, dtype=torch.int64, device=dev)

    @property
    def n(self):
        return self.shape[0]

    @property
    def nterms(self):
        return self._nterms

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @staticmethod
    def _group_apply(L, U, tidx, WT):
        """``L @ u`` with ``u_r = sum_n U[n, r] WT[tidx[r], n]``; the gather
        goes through the row-major view, so its result lies as ``U`` does."""
        return L @ torch.sum(U * WT.T[:, tidx], dim=0)

    def _main_pair(self, WreT, WimT):
        """The main bank applied to both term-major channels: one pair
        launch on a DIA bank, two applies on a CSR or dense one."""
        WreT, WimT = WreT[self._sel], WimT[self._sel]
        if hasattr(self.inner, "lincomb_apply_pair_t"):
            return self.inner.lincomb_apply_pair_t(WreT, WimT)
        return self.inner.lincomb_apply(WreT.T), self.inner.lincomb_apply(
            WimT.T)

    def lincomb_apply_split_t(self, WreT, WimT):
        """(yre, yim) = re/im of ``sum_i A_i (WreT + i WimT)[i]`` for
        term-major channels ``(nterms, n)``."""
        yre, yim = self._main_pair(WreT, WimT)
        if self.Lr is not None:
            yre = yre + self._group_apply(self.Lr, self.Ur, self._tr, WreT)
            yim = yim + self._group_apply(self.Lr, self.Ur, self._tr, WimT)
        if self.Li is not None:
            yre = yre - self._group_apply(self.Li, self.Ui, self._ti, WimT)
            yim = yim + self._group_apply(self.Li, self.Ui, self._ti, WreT)
        return yre, yim

    def lincomb_apply_split(self, Wre, Wim):
        """:meth:`lincomb_apply_split_t` for row-major channels
        ``(n, nterms)``."""
        return self.lincomb_apply_split_t(Wre.T, Wim.T)

    def lincomb_apply(self, W):
        """``y = sum_i A_i W[:, i]`` (original term order; complex aware)."""
        if W.is_complex() or self.Li is not None:
            Wre = W.real if W.is_complex() else W
            Wim = W.imag if W.is_complex() else torch.zeros_like(W)
            yre, yim = self.lincomb_apply_split(Wre, Wim)
            return torch.complex(yre, yim)
        y = self.inner.lincomb_apply(W[:, self._sel])
        if self.Lr is not None:
            y = y + self._group_apply(self.Lr, self.Ur, self._tr, W.T)
        return y

    def host_csr_terms(self):
        import scipy.sparse as sp

        inner_terms = self.inner.host_csr_terms()
        out = [None] * self.nterms
        for j, i in enumerate(self.main_idx):
            out[i] = inner_terms[j]
        for L, U, tidx, fac in ((self.Lr, self.Ur, self.tidx_r, 1.0),
                                (self.Li, self.Ui, self.tidx_i, 1j)):
            if L is None:
                continue
            Lh, Uh = L.cpu().numpy(), U.cpu().numpy()
            for i in set(tidx):
                sel = [r for r, t in enumerate(tidx) if t == i]
                T = sp.csr_matrix(fac * (Lh[:, sel] @ Uh[:, sel].T))
                out[i] = T if out[i] is None else out[i] + T
        return out


def make_mixed_bank(mats, dtype=None, max_rank=None, fmt=None, device=None):
    """Partition ``mats`` (real or complex scipy/dense) into real main-bank
    terms and stacked low-rank terms by nonzero support.

    A term's real part goes low-rank when min(#nonzero rows, #nonzero cols)
    is at most ``max_rank`` (default ``max(32, n // 64)``); imaginary parts
    must be low-rank (the main bank is real).  ``device=None`` is the card
    (``config.default_device``)."""
    import scipy.sparse as sp

    from ..models.lowrank import low_rank_factors
    from .sparse import make_term_bank

    device = resolve_device(device)
    seq = [sp.csr_matrix(A) if not sp.issparse(A) else A.tocsr() for A in mats]
    n = seq[0].shape[0]
    if max_rank is None:
        max_rank = max(32, n // 64)
    rdt = to_numpy_dtype(dtype) if dtype is not None else np.dtype(np.float64)
    if np.issubdtype(rdt, np.complexfloating):
        rdt = np.dtype(np.float64 if rdt == np.complex128 else np.float32)

    def support(A):
        coo = A.tocoo()
        if coo.nnz == 0:
            return 0
        return min(len(np.unique(coo.row)), len(np.unique(coo.col)))

    main_idx = []
    Lr_, Ur_, tidx_r = [], [], []
    Li_, Ui_, tidx_i = [], [], []
    for i, A in enumerate(seq):
        if np.iscomplexobj(A.data):
            # copy the index arrays: eliminate_zeros mutates in place and the
            # terms of an aligned-pattern bank share indices/indptr buffers
            Are = sp.csr_matrix(
                (A.data.real.copy(), A.indices.copy(), A.indptr.copy()),
                shape=A.shape)
            Aim = sp.csr_matrix(
                (A.data.imag.copy(), A.indices.copy(), A.indptr.copy()),
                shape=A.shape)
            Are.eliminate_zeros()
            Aim.eliminate_zeros()
        else:
            Are, Aim = A, None
        if Aim is not None and Aim.nnz:
            si = support(Aim)
            if si > max_rank:
                raise ValueError(
                    f"operand {i}: imaginary part has support {si} > "
                    f"max_rank {max_rank}; the complex-as-real mixed bank "
                    "needs low-rank imaginary parts")
            L, U = low_rank_factors(Aim)
            Li_.append(L)
            Ui_.append(U)
            tidx_i.extend([i] * L.shape[1])
        if Are.nnz and support(Are) <= max_rank:
            L, U = low_rank_factors(Are)
            Lr_.append(L)
            Ur_.append(U)
            tidx_r.extend([i] * L.shape[1])
        else:
            # bulk term: arrow-split so the main bank stays banded; border
            # rows/cols ride as exact low-rank factors
            from .partitioned import arrow_split

            seq[i] = Are
            split = arrow_split(Are, max_rank) if Are.nnz else None
            if split is not None and split[1]:
                band, factors = split
                seq[i] = band
                for L, U in factors:
                    Lr_.append(L.real)
                    Ur_.append(U.real)
                    tidx_r.extend([i] * L.shape[1])
            main_idx.append(i)

    if not main_idx:  # the inner bank needs at least one term
        i = tidx_r[0] if tidx_r else 0
        keep = [r for r, t in enumerate(tidx_r) if t != i]
        if Lr_:
            Lr_cat, Ur_cat = np.hstack(Lr_), np.hstack(Ur_)
            Lr_ = [Lr_cat[:, keep]] if keep else []
            Ur_ = [Ur_cat[:, keep]] if keep else []
        tidx_r = [t for t in tidx_r if t != i]
        main_idx = [i]

    tdt = to_torch_dtype(rdt)

    def cat(parts):
        if not parts:
            return None
        h = np.ascontiguousarray(np.hstack(parts).real)
        return torch.from_numpy(h).to(device=device, dtype=tdt)

    inner = make_term_bank(
        [seq[i].real if np.iscomplexobj(seq[i].data) else seq[i]
         for i in main_idx],
        dtype=rdt, fmt=fmt, device=device)
    # Frobenius norms on the host from the scipy/numpy factors
    fro = np.zeros(len(seq))
    inner_fro = inner.fro_norms.cpu().numpy()
    for j, i in enumerate(main_idx):
        fro[i] = inner_fro[j]
    fro2 = fro**2
    for parts_L, parts_U, tidx in ((Lr_, Ur_, tidx_r), (Li_, Ui_, tidx_i)):
        if not parts_L:
            continue
        Lh, Uh = np.hstack(parts_L), np.hstack(parts_U)
        for i in set(tidx):
            sel = [r for r, t in enumerate(tidx) if t == i]
            # ||L U^T||_F^2 = trace((U^T U)(L^T L)) without the n x n product
            G = (Uh[:, sel].T @ Uh[:, sel]) * (Lh[:, sel].T @ Lh[:, sel]).T
            fro2[i] += float(G.sum())
    return MixedTermBank(inner, cat(Lr_), cat(Ur_), cat(Li_), cat(Ui_),
                         main_idx, tidx_r, tidx_i, (n, n), len(seq),
                         fro_norms=torch.from_numpy(np.sqrt(fro2)))
