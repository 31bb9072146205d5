"""DtN Helmholtz resonances with Bessel-quotient functions
(Araujo-Cabarcas/Engstrom/Jarlebring JCAM 2018).  The FEM matrices are
downloaded separately; this module holds the naive PETSc binary reader,
the Bessel-quotient term ``BesselNEP`` and the loader."""
from __future__ import annotations

import os

import numpy as np
import torch

from ...config import resolve_device
from ...core.nep import NEP
from ...ops import matfun
from ...ops.sparse import CSR
from ..spmf import SPMF_NEP
from ..sumnep import SumNEP

__all__ = ["naive_petsc_read", "besselh_quotient", "besselh_quotient_der",
           "BesselNEP", "load_dtn_dimer"]

_MAT_CLASSID = 1211216
_VEC_CLASSID = 1211214


def naive_petsc_read(filename, int_dtype=">i4", float_dtype=">c16"):
    """A PETSc binary sparse matrix (scipy CSR) or vector (numpy)."""
    import scipy.sparse as sp

    with open(filename, "rb") as f:
        class_id = int(np.fromfile(f, dtype=int_dtype, count=1)[0])
        if class_id == _MAT_CLASSID:
            rows, cols, nnz = (int(x) for x in np.fromfile(
                f, dtype=int_dtype, count=3))
            row_lens = np.fromfile(f, dtype=int_dtype,
                                   count=rows).astype(np.int64)
            indptr = np.concatenate([[0], np.cumsum(row_lens)])
            indices = np.fromfile(f, dtype=int_dtype,
                                  count=nnz).astype(np.int64)
            vals = np.fromfile(f, dtype=float_dtype,
                               count=nnz).astype(complex)
            return sp.csr_matrix((vals, indices, indptr), shape=(rows, cols))
        if class_id == _VEC_CLASSID:
            rows = int(np.fromfile(f, dtype=int_dtype, count=1)[0])
            return np.fromfile(f, dtype=float_dtype,
                               count=rows).astype(complex)
        raise ValueError("Unsupported class_id. This function can only load "
                         "sparse arrays and vectors.")


def _besselh(nu, z):
    from scipy.special import hankel1

    return hankel1(nu, z)


def besselh_quotient(nu, s):
    """``besselh'(nu, s) / besselh(nu, s)`` (scalar)."""
    Fder = 0.5 * (_besselh(nu - 1, s) - _besselh(nu + 1, s))
    return Fder / _besselh(nu, s)


def besselh_quotient_der(nu, s):
    """The derivative of :func:`besselh_quotient` in ``s``."""
    Fdd = 0.25 * (_besselh(nu - 2, s) - 2 * _besselh(nu, s)
                  + _besselh(nu + 2, s))
    Fd = 0.5 * (_besselh(nu - 1, s) - _besselh(nu + 1, s))
    F = _besselh(nu, s)
    return (Fdd * F - Fd * Fd) / F**2


def _fvals(ind2, lam, der):
    """The term values ``d^der/dlam^der [-lam B'_m(lam)/B_m(lam)]`` for
    every order m of ``ind2`` (der 0 or 1)."""
    if der == 0:
        return np.array([-lam * besselh_quotient(m, lam) for m in ind2])
    if der == 1:
        return np.array([-besselh_quotient(m, lam)
                         - lam * besselh_quotient_der(m, lam) for m in ind2])
    raise NotImplementedError("Higher derivatives not implemented")


class BesselNEP(NEP):
    """The DtN part ``sum_i P_i (-s B'_m(s) / B_m(s))`` with ``P_i`` the
    rank-one terms of the columns of ``Q``."""

    def __init__(self, Q, P, ind2, n, device=None):
        self.device = resolve_device(device)
        self.Qh = np.asarray(Q)
        self.Q = torch.as_tensor(self.Qh, dtype=torch.complex128,
                                 device=self.device)
        self.P = P
        self.ind2 = list(ind2)
        self.n = n

    def Mder(self, lam, der: int = 0):
        import scipy.sparse as sp

        lam = complex(lam)
        A = sp.csr_matrix((self.n, self.n), dtype=complex)
        for fval, Pi in zip(_fvals(self.ind2, lam, der), self.P):
            A = A + fval * Pi
        return CSR.from_scipy(A, device=self.device)

    def Mder_dense(self, lam, der: int = 0):
        return self.Mder(lam, der).to_dense()

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        V = torch.as_tensor(V, device=self.device).to(torch.complex128)
        if V.ndim == 1:
            V = V[:, None]
        a = np.ones(V.shape[1]) if a is None else np.asarray(
            a.cpu() if isinstance(a, torch.Tensor) else a)
        lam = complex(lam)
        nq = len(self.ind2)
        Qn = self.Q[:, :nq]
        v = torch.zeros(self.n, dtype=torch.complex128, device=self.device)
        for j in range(V.shape[1]):
            W = Qn.conj().T @ V[:, j]
            z = W * torch.as_tensor(_fvals(self.ind2, lam, j + startder),
                                    device=self.device)
            v = v + complex(a[j]) * (Qn @ z)
        return v


def load_dtn_dimer(data_dir, l=40, device=None):
    """The dimer problem from the downloaded K.bin/M.bin/q*.bin FEM data in
    ``data_dir``."""
    import scipy.sparse as sp

    kpath = os.path.join(data_dir, "K.bin")
    if not os.path.exists(kpath):
        raise FileNotFoundError(
            f"dtn_dimer data not found in {data_dir}; download the FEM "
            "matrices as described in Araujo-Cabarcas et al. 2018")
    device = resolve_device(device)
    A = naive_petsc_read(kpath)
    M = naive_petsc_read(os.path.join(data_dir, "M.bin"))
    n = A.shape[0]
    q1 = naive_petsc_read(os.path.join(data_dir, "q1.bin"))
    start_dtn = int(np.flatnonzero(np.abs(q1) > 0)[0])
    files = sorted(f for f in os.listdir(data_dir) if f.startswith("q"))
    mid = round((len(files) - 1) / 2 + 1)
    l = min(mid - 1, l)
    ind = np.arange(mid - l, mid + l + 1)
    ind2 = ind - mid
    Q = np.empty((n, len(ind)), dtype=complex)
    P = []
    for i, idx in enumerate(ind):
        q = naive_petsc_read(os.path.join(data_dir, f"q{idx}.bin")) / np.sqrt(
            2 * np.pi)
        Q[:, i] = q
        qnz = q[start_dtn:]
        Qnz = sp.csr_matrix(np.outer(qnz, np.conj(qnz)))
        I, J = Qnz.nonzero()
        P.append(sp.csr_matrix((Qnz[I, J].A1, (I + start_dtn, J + start_dtn)),
                               shape=(n, n)))

    def minus_square(S):
        return -(S @ S) if S.ndim >= 2 else -(S**2)

    nep1 = SPMF_NEP([A, M], [matfun.eye_like, minus_square], device=device)
    return SumNEP(nep1, BesselNEP(Q, P, ind2, n, device=device))
