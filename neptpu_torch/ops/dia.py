"""Stacked-diagonal (DIA) term banks — the streaming SpMV format for banded
operators.

Storage: shared ``offsets (ndiag,)``; stacked ``data (m_terms, ndiag, n)``
with ``data[i, d, r] = A_i[r, r + offsets[d]]`` (zero where out of range).
The fused multi-term apply ``y = sum_i A_i W[:, i]`` runs the hand-written
CUDA kernel (``ops/dia_kernel.py``) on a CUDA tensor and its plain PyTorch
twin on a CPU tensor; any other device raises.  The kernel's operand is
term-major, ``WT (m_terms, n)``: the ``*_t`` entries take it as it is, the
row-major entries (``W (n, m_terms)``) transpose once and call them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, to_numpy_dtype
from .dia_kernel import (DiaLauncher, dia_lincomb_pair_plain,
                         dia_lincomb_plain, shifted_rows)

__all__ = ["DiaTermBank"]


class DiaTermBank:
    is_sparse = True

    def __init__(self, data, offsets, shape, fro_norms=None, host_data=None):
        self.data = data.contiguous()  # (m, ndiag, n)
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)
        if fro_norms is None:
            fro_norms = torch.sqrt(torch.sum(torch.abs(data) ** 2, dim=(1, 2)))
        self.fro_norms = fro_norms
        self._host_data = host_data  # construction-time numpy mirror
        self._launchers = {}  # dtype -> the bank prepared for launching

    @property
    def nterms(self):
        return self.data.shape[0]

    @property
    def n(self):
        return self.shape[0]

    @property
    def ndiag(self):
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @classmethod
    def from_matrices(cls, mats, dtype=None, device=None):
        import scipy.sparse as sp

        device = resolve_device(device)
        mats = [sp.csr_matrix(A) if not sp.issparse(A) else A.tocsr()
                for A in mats]
        n = mats[0].shape[0]
        offs = sorted(set().union(*[set(A.todia().offsets.tolist())
                                    for A in mats]))
        if dtype is None:
            dtype = np.result_type(*[A.dtype for A in mats])
        data = np.zeros((len(mats), len(offs), n), dtype=to_numpy_dtype(dtype))
        for i, A in enumerate(mats):
            D = A.todia()
            for od, off in enumerate(D.offsets):
                d = offs.index(off)
                # scipy dia stores data[k, j] = A[j - off, j]; we want
                # data[d, r] = A[r, r + off] -> shift by off
                col = D.data[od]
                if col.shape[0] < n:  # scipy >= 1.17 trims empty tail cols
                    col = np.pad(col, (0, n - col.shape[0]))
                if off >= 0:
                    data[i, d, : n - off] = col[off:]
                else:
                    data[i, d, -off:] = col[: n + off]
        return cls(torch.from_numpy(data).to(device), offs, (n, n),
                   host_data=data)

    def host_csr_terms(self):
        """scipy CSR mirrors of every term, from host data when available."""
        import scipy.sparse as sp

        n = self.n
        data = (self._host_data if self._host_data is not None
                else self.data.cpu().numpy())
        r = np.arange(n)
        out = []
        for i in range(data.shape[0]):
            rows, cols, vals = [], [], []
            for d, off in enumerate(self.offsets):
                rr = r[: n - off] if off >= 0 else r[-off:]
                rows.append(rr)
                cols.append(rr + off)
                vals.append(data[i, d][rr])
            out.append(sp.csr_matrix(
                (np.concatenate(vals),
                 (np.concatenate(rows), np.concatenate(cols))),
                shape=(n, n)))
        return out

    def astype(self, dtype):
        """The same bank with its values in ``dtype`` (a torch dtype;
        ``torch.bfloat16`` for the half-width bank of the bf16 kernel)."""
        return DiaTermBank(self.data.to(dtype), self.offsets, self.shape,
                           host_data=self._host_data)

    def padded(self, p, eye_first=False):
        """The terms with ``p`` zero rows and columns appended, in the same
        storage and with the same offsets (the deflated problem's original
        terms).  ``eye_first``: an identity on the first n rows comes first
        (a delay problem's ``-lam I`` term, which its bank does not hold).

        Entries whose column falls outside the n x n matrix are zeroed, so
        the appended columns stay zero whatever the stored layout held
        there."""
        n, offs = self.n, self.offsets
        data, fro = self.data, self.fro_norms.to(self.device)
        if eye_first:
            if 0 not in offs:
                offs = tuple(sorted(offs + (0,)))
                d = offs.index(0)
                data = torch.cat([data[:, :d], torch.zeros_like(data[:, :1]),
                                  data[:, d:]], dim=1)
            eye = torch.zeros_like(data[:1])
            eye[0, offs.index(0)] = 1.0
            data = torch.cat([eye, data])
            fro = torch.cat([torch.full((1,), float(np.sqrt(n)),
                                        dtype=fro.dtype, device=fro.device),
                             fro])
        r = torch.arange(n, device=self.device)
        inside = torch.stack([(r + o >= 0) & (r + o < n) for o in offs])
        data = torch.nn.functional.pad(data * inside.to(data.dtype), (0, p))
        return DiaTermBank(data, offs, (n + p, n + p), fro_norms=fro)

    def launcher(self, dt):
        """The bank prepared for kernel launches in ``dt``, built at first
        use per dtype: the stored values themselves when the dtype matches
        (the scan's case), else a converted copy made once."""
        launcher = self._launchers.get(dt)
        if launcher is None:
            launcher = self._launchers[dt] = DiaLauncher(
                self.data.to(dt), self.offsets)
        return launcher

    def lincomb_apply_t(self, WT):
        """``y = sum_i A_i @ WT[i]`` for a term-major operand ``WT (m, n)``.

        A CPU tensor takes the plain twin; any other device launches the CUDA
        kernel (which raises on what it does not take).  The bank's data is
        real, so a complex ``WT`` is the pair apply of its re and im parts
        (one kernel launch on the card).

        A bfloat16 bank applied to a bfloat16 operand gives a float32 result
        from float32 products and sums, on the card and on the CPU alike: the
        port follows the TPU kernel (``neptpu/ops/pallas_spmv.py``), not the
        JAX package's non-Pallas path, which sums in bfloat16 and returns
        bfloat16."""
        dt = torch.promote_types(WT.dtype, self.data.dtype)
        if dt.is_complex:
            Wc = WT.to(dt)
            yre, yim = self.lincomb_apply_pair_t(Wc.real, Wc.imag)
            return torch.complex(yre, yim)
        if WT.device.type == "cpu":
            return dia_lincomb_plain(self.data.to(dt), self.offsets,
                                     WT.to(dt))
        return self.launcher(dt).single(WT.to(dt).contiguous())

    def lincomb_apply_pair_t(self, WreT, WimT):
        """``(sum_i A_i @ WreT[i], sum_i A_i @ WimT[i])`` for a real
        term-major operand pair - the re/im channels of the complex-as-real
        scan, as the scan holds them.  On the card this is ONE kernel launch
        that reads the bank once; on the CPU the plain twin.  bfloat16 bank
        and operands: float32 results, as in :meth:`lincomb_apply_t`."""
        dt = self.data.dtype
        if WreT.dtype != dt or WimT.dtype != dt:
            dt = torch.promote_types(
                torch.promote_types(WreT.dtype, WimT.dtype), dt)
            if dt.is_complex:
                raise TypeError("the pair apply takes real re/im channels, "
                                f"got {WreT.dtype} and {WimT.dtype}")
            WreT, WimT = WreT.to(dt), WimT.to(dt)
        if WreT.device.type == "cpu":
            return dia_lincomb_pair_plain(self.data.to(dt), self.offsets,
                                          WreT, WimT)
        return self.launcher(dt).pair(WreT.contiguous(), WimT.contiguous())

    # the name the complex-as-real scans look for: one launch per step
    lincomb_apply_split_t = lincomb_apply_pair_t

    def lincomb_apply(self, W):
        """``y = sum_i A_i @ W[:, i]`` for a row-major operand ``W (n, m)``:
        :meth:`lincomb_apply_t` of its transpose."""
        return self.lincomb_apply_t(W.T)

    def lincomb_apply_pair(self, Wre, Wim):
        """:meth:`lincomb_apply_pair_t` for row-major channels ``(n, m)``."""
        return self.lincomb_apply_pair_t(Wre.T, Wim.T)

    lincomb_apply_split = lincomb_apply_pair

    def combine(self, w):
        """``sum_i w_i A_i`` as a new single-term bank."""
        w = torch.as_tensor(w).to(self.device)
        dt = torch.promote_types(w.dtype, self.data.dtype)
        nz = torch.tensordot(w.to(dt), self.data.to(dt), dims=1)  # (ndiag, n)
        return DiaTermBank(nz[None], self.offsets, self.shape)

    def combine_dense(self, w):
        """``sum_i w_i A_i`` as a dense (n, n) matrix."""
        return self.to_dense_sum(w)

    def term(self, i):
        """Single-term view (matvec/matmat/to_dense/@)."""
        return DiaTermBank(self.data[i][None], self.offsets, self.shape)

    def term_dense(self, i):
        """Term ``i`` as a dense (n, n) matrix."""
        return self.term(i).to_dense()

    def to_dense(self):
        """Dense matrix of a single-term bank."""
        if self.nterms != 1:
            raise ValueError("to_dense needs a single-term bank")
        return self.to_dense_sum(torch.ones(1, dtype=self.dtype))

    def to_dense_sum(self, w):
        n = self.n
        w = torch.as_tensor(w).to(self.device)
        dt = torch.promote_types(w.dtype, self.data.dtype)
        nz = torch.tensordot(w.to(dt), self.data.to(dt), dims=1)
        M = torch.zeros(self.shape, dtype=dt, device=self.device)
        r = torch.arange(n, device=self.device)
        for d, off in enumerate(self.offsets):
            rows = r[: n - off] if off >= 0 else r[-off:]
            M[rows, rows + off] += nz[d][rows]
        return M

    def __matmul__(self, x):
        return self.matvec(x) if x.ndim == 1 else self.matmat(x)

    def matvec(self, x):
        """Single combined-matrix matvec (nterms must be 1)."""
        dt = torch.promote_types(x.dtype, self.data.dtype)
        x = x.to(dt)
        y = torch.zeros(self.n, dtype=dt, device=x.device)
        for d, off in enumerate(self.offsets):
            y = y + self.data[0, d, :].to(dt) * shifted_rows(x, off)
        return y

    def matmat(self, X):
        dt = torch.promote_types(X.dtype, self.data.dtype)
        X = X.to(dt)
        Y = torch.zeros(X.shape, dtype=dt, device=X.device)
        for d, off in enumerate(self.offsets):
            Y = Y + self.data[0, d, :, None].to(dt) * shifted_rows(X, off)
        return Y

    def lincomb_apply_mat(self, W):
        """``sum_i A_i @ W[:, :, i]`` for W (n, k, m) -> (n, k)."""
        dt = torch.promote_types(W.dtype, self.data.dtype)
        W = W.to(dt)
        y = torch.zeros(W.shape[:2], dtype=dt, device=W.device)
        for d, off in enumerate(self.offsets):
            y = y + torch.einsum("in,nki->nk", self.data[:, d, :].to(dt),
                                 shifted_rows(W, off))
        return y

    def mm_apply(self, V, F):
        """``sum_i A_i @ (V @ F_i)`` with F stacked (m, k, k)."""
        dt = torch.promote_types(torch.promote_types(V.dtype, F.dtype),
                                 self.data.dtype)
        VF = torch.einsum("nk,mkl->nlm", V.to(dt), F.to(dt).to(V.device))
        return self.lincomb_apply_mat(VF)
