"""Effenberger deflation: extend a NEP with an invariant pair (S0, V0) into

    [ M(lam)   U(lam) ]
    [ X^H        0    ]        X = V0, U(lam) from M and (lam I - S0)^{-1}

so that converged pairs never reconverge.  Three representations:

* ``:SPMF``    - diagonalize S0 and extend the SPMF with low-rank terms
  (``create_spmf_dnep``); the result is again an SPMF.  The original terms
  keep their storage, padded with p zero rows and columns (a DIA bank stays
  a DIA bank with the same offsets, so the kernel applies the deflated
  problem), and the deflation terms keep their factors (``models/lowrank``),
  where the JAX package forms both as dense (n+p)^2 arrays.
* ``:Generic`` - binomial-expansion compute functions.
* ``:MM``      - everything through ``compute_MM`` on a bordered pencil.

The p x p and n x p bookkeeping (``S0``, ``V0``) is host numpy complex128, as
in the JAX package; ``V0_t`` is ``V0`` on the original problem's device,
where the n-sized work runs.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..core.nep import (NEP, compute_Mder, compute_Mlincomb, compute_MM,
                        mder_from_mm, mlincomb_from_mder, mlincomb_from_mm)
from ..ops import matfun
from ..ops.sparse import DenseTermBank
from ..solvers.common import nep_device
from .dep import DEP
from .lowrank import LowRankFactorizedNEP
from .spmf import AbstractSPMF, SPMF_NEP
from .sumnep import SPMFSumNEP

__all__ = [
    "DeflatedNEP",
    "DeflatedNEPMM",
    "DeflatedGenericNEP",
    "DeflatedSPMF",
    "create_spmf_dnep",
    "deflate_eigpair",
    "get_deflated_eigpairs",
    "deflated_nep_compute_Q",
    "normalize_schur_pair",
]

_C = torch.complex128


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def normalize_schur_pair(S, V):
    """Make V orthonormal: ``V = QR``, ``S <- R S R^{-1}`` (host numpy)."""
    S = np.asarray(S, dtype=complex)
    V = np.asarray(V, dtype=complex)
    if V.shape[1] > V.shape[0]:
        warnings.warn("Cannot normalize short and skinny V-matrices.")
        return S, V
    Q, R = np.linalg.qr(V)
    return R @ S @ np.linalg.inv(R), Q


class _DeflatedBase(NEP):
    def __init__(self, orgnep, S0, V0):
        self.orgnep = orgnep
        self.S0 = np.asarray(_host(S0), dtype=complex)
        self.V0 = np.asarray(_host(V0), dtype=complex)
        device = nep_device(orgnep) or torch.device("cpu")
        self.V0_t = torch.as_tensor(self.V0, device=device)
        self.n = orgnep.n + self.S0.shape[0]

    @property
    def n0(self):
        return self.orgnep.n

    @property
    def p(self):
        return self.S0.shape[0]


class DeflatedNEPMM(_DeflatedBase):
    """All compute functions through ``compute_MM`` on the bordered pencil."""

    def MM(self, S, V):
        n0, p0 = self.n0, self.p
        S = _host(S).astype(complex)
        p = S.shape[0]
        V1 = V[:n0, :].to(_C)
        V2 = _host(V[n0:, :])
        Stilde = np.block([[self.S0, V2],
                           [np.zeros((p, p0), dtype=complex), S]])
        Vtilde = torch.cat([self.V0_t, V1], dim=1)
        R = compute_MM(self.orgnep, torch.as_tensor(Stilde), Vtilde)
        return torch.cat([R[:n0, p0:], self.V0_t.conj().T @ V1])

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return mlincomb_from_mm(self, lam, V, a, startder)

    def Mder(self, lam, der: int = 0):
        return mder_from_mm(self, lam, der)

    Mder_dense = Mder


def deflated_nep_compute_Q(nep: _DeflatedBase, lam, der: int):
    """The ``U^(der)(lam)`` block ``(n0, p)`` on the original's device."""
    p = nep.p
    lam = complex(lam)
    Ainv = torch.as_tensor(np.linalg.inv(lam * np.eye(p) - nep.S0),
                           device=nep.V0_t.device)
    Q = torch.zeros((nep.n0, p), dtype=_C, device=nep.V0_t.device)
    Vnew = nep.V0_t
    for i in range(der, -1, -1):
        Vnew = Vnew @ Ainv  # Vnew / (lam I - S)
        factor = ((-1.0) ** (der - i)) * (math.factorial(der)
                                          / math.factorial(i))
        for j in range(p):
            Q[:, j] += compute_Mlincomb(nep.orgnep, lam, Vnew[:, j:j + 1],
                                        np.array([factor]), startder=i)
    return Q


class DeflatedGenericNEP(_DeflatedBase):
    """Binomial-expansion compute functions."""

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if startder != 0:
            return mlincomb_from_mder(self, lam, V, a, startder)
        if V.ndim == 1:
            V = V[:, None]
        k = V.shape[1]
        a = np.ones(k) if a is None else _host(a)
        n0, p = self.n0, self.p
        lam_c = complex(lam)
        A = lam_c * np.eye(p) - self.S0
        Xhat = self.V0_t @ torch.as_tensor(np.linalg.inv(A),
                                           device=V.device)  # X / (lam I - S)
        V2 = _host(V[n0:, :]).astype(complex)
        # Qs[i][:, j] = (lam I - S)^{-(i-j)} V2[:, i]
        Qs = []
        for i in range(k):
            QQ = np.zeros((p, k), dtype=complex)
            QQ[:, i] = V2[:, i]
            for j in range(i - 1, -1, -1):
                QQ[:, j] = np.linalg.solve(A, QQ[:, j + 1])
            Qs.append(QQ)
        C = np.zeros((p, k), dtype=complex)  # Z = Xhat @ C
        for j in range(k):
            for i in range(j, k):
                factor = ((-1.0) ** (i - j)) * (a[i] * math.factorial(i)
                                                / math.factorial(j))
                C[:, j] += factor * Qs[i][:, j]
        at = torch.as_tensor(a, device=V.device).to(_C)
        Vnew = V[:n0, :].to(_C) * at[None, :] + Xhat @ torch.as_tensor(
            C, device=V.device)
        z_top = compute_Mlincomb(self.orgnep, lam, Vnew)
        z_bottom = self.V0_t.conj().T @ V[:n0, 0].to(_C) * at[0]
        return torch.cat([z_top.to(_C), z_bottom])

    def Mder(self, lam, der: int = 0):
        n0, p = self.n0, self.p
        dev = self.V0_t.device
        Q = deflated_nep_compute_Q(self, lam, der)
        M0 = _dense(compute_Mder(self.orgnep, lam, der)).to(_C)
        bottom = (self.V0_t.conj().T if der == 0
                  else torch.zeros((p, n0), dtype=_C, device=dev))
        return torch.cat([torch.cat([M0, Q], dim=1),
                          torch.cat([bottom, torch.zeros((p, p), dtype=_C,
                                                         device=dev)],
                                    dim=1)])

    Mder_dense = Mder

    def MM(self, S, V):
        return DeflatedNEPMM.MM(self, S, V)


class DeflatedSPMF(AbstractSPMF, _DeflatedBase):
    """SPMF-form deflation: the padded original plus the low-rank deflation
    terms (``create_spmf_dnep``)."""

    def __init__(self, orgnep, spmf, S0, V0):
        _DeflatedBase.__init__(self, orgnep, S0, V0)
        self.spmf = spmf

    @property
    def bank(self):
        return getattr(self.spmf, "bank", None)

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
        return _dense(self.spmf.Mder(lam, der))

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return self.spmf.Mlincomb(lam, V, a=a, startder=startder)

    def MM(self, S, V):
        return self.spmf.MM(S, V)


DeflatedNEP = (_DeflatedBase,)


def _padded_spmf(nep, p):
    """The original's terms padded with ``p`` zero rows and columns, in the
    original's storage where its bank holds the terms (a delay problem's
    bank gains its ``-lam I`` term; a sum is padded part by part), else as
    dense terms."""
    if isinstance(nep, SPMFSumNEP):
        return SPMFSumNEP(_padded_spmf(nep.nep1, p), _padded_spmf(nep.nep2, p))
    fv = list(nep.get_fv())
    bank = getattr(nep, "bank", None)
    if bank is not None and hasattr(bank, "padded"):
        if bank.nterms == len(fv):
            return SPMF_NEP(None, fv, bank=bank.padded(p),
                            check_consistency=False)
        if isinstance(nep, DEP):
            return SPMF_NEP(None, fv, bank=bank.padded(p, eye_first=True),
                            check_consistency=False)
    A = torch.stack([_dense(A) for A in nep.get_Av()])
    return SPMF_NEP(None, fv, bank=DenseTermBank(
        torch.nn.functional.pad(A, (0, p, 0, p))), check_consistency=False)


def _resolvent_term(fr, li):
    """``S -> (S - li I)^{-1} fr(S)``; a 0-dim ``S`` is the scalar form.  At
    ``S = li`` (a deflated eigenvalue) the solve gives non-finite values, as
    LAPACK's does in the JAX package, instead of raising."""
    def f(S):
        if S.ndim < 2:
            return fr(S) / (S - li)
        A = S - li * matfun.eye_like(S)
        return torch.linalg.solve_ex(A, fr(S).to(A.dtype))[0]

    return f


def _apply(A, x):
    if isinstance(A, torch.Tensor):
        return A.to(torch.promote_types(A.dtype, x.dtype)) @ x
    return A.matvec(x)


def create_spmf_dnep(nep: AbstractSPMF, S0, V0):
    """Extend an SPMF with the deflation terms as a low-rank SPMF sum."""
    Av_org = nep.get_Av()
    fv_org = nep.get_fv()
    S0 = np.asarray(_host(S0), dtype=complex)
    V0 = np.asarray(_host(V0), dtype=complex)
    p = V0.shape[1]
    n0 = nep.n
    device = nep_device(nep) or torch.device("cpu")
    V0_t = torch.as_tensor(V0, device=device)
    spmf1 = _padded_spmf(nep, p)

    # the deflation terms (diagonalize S0)
    lam_d, Xd = np.linalg.eig(S0)
    zeros_p = torch.zeros(p, dtype=_C, device=device)
    zeros_n = torch.zeros(n0, dtype=_C, device=device)
    L2, U2, fv2 = [], [], []
    for i in range(p):
        y = V0_t @ torch.as_tensor(Xd[:, i], device=device)
        x = np.linalg.solve(Xd.T, np.eye(p)[i])  # row e_i' / X
        ux = torch.cat([zeros_n, torch.as_tensor(x.conj(), device=device)])
        for fr, Ar in zip(fv_org, Av_org):
            L2.append(torch.cat([_apply(Ar, y).to(_C), zeros_p])[:, None])
            U2.append(ux[:, None])
            fv2.append(_resolvent_term(fr, complex(lam_d[i])))
    L2.append(torch.cat([torch.zeros((n0, p), dtype=_C, device=device),
                         torch.eye(p, dtype=_C, device=device)]))
    U2.append(torch.cat([V0_t, torch.zeros((p, p), dtype=_C,
                                           device=device)]))
    fv2.append(matfun.eye_like)
    spmf2 = LowRankFactorizedNEP(L2, U2, fv2, device=device)
    return SPMFSumNEP(spmf1, spmf2)


def _verify_mode(nep, mode):
    if mode == ":Auto":
        if isinstance(nep, DeflatedSPMF):
            return ":SPMF"
        if isinstance(nep, DeflatedNEPMM):
            return ":MM"
        if isinstance(nep, DeflatedGenericNEP):
            return ":Generic"
        return ":SPMF" if isinstance(nep, AbstractSPMF) else ":Generic"
    return mode


def _make(orgnep, S1, V1, mode):
    if mode == ":MM":
        return DeflatedNEPMM(orgnep, S1, V1)
    if mode == ":SPMF":
        if not isinstance(orgnep, AbstractSPMF):
            raise ValueError("SPMF-mode only possible for AbstractSPMF-NEPs")
        return DeflatedSPMF(orgnep, create_spmf_dnep(orgnep, S1, V1), S1, V1)
    if mode == ":Generic":
        return DeflatedGenericNEP(orgnep, S1, V1)
    raise ValueError(f"unknown deflation mode {mode}")


def _extend_pair(nep, lam, v):
    """The invariant pair of a deflated ``nep`` extended by ``(lam, v)``."""
    n, p0 = nep.n0, nep.p
    V1 = np.zeros((n, p0 + 1), dtype=complex)
    S1 = np.zeros((p0 + 1, p0 + 1), dtype=complex)
    V1[:, :-1] = nep.V0
    V1[:, -1] = v[:n]
    S1[:-1, :-1] = nep.S0
    S1[:, -1] = np.concatenate([v[n:], [complex(lam)]])
    return S1, V1


def deflate_eigpair(nep, lam, v, mode=":Auto"):
    """Create or extend a deflated NEP from the eigenpair ``(lam, v)``
    (``v``: a tensor or array)."""
    mode = _verify_mode(nep, mode)
    v = np.asarray(_host(v), dtype=complex).reshape(-1)
    if isinstance(nep, _DeflatedBase):
        S1, V1 = normalize_schur_pair(*_extend_pair(nep, lam, v))
        return _make(nep.orgnep, S1, V1, mode)
    S0, V0 = normalize_schur_pair(np.array([[complex(lam)]]),
                                  v.reshape(nep.n, 1))
    return _make(nep, S0, V0, mode)


def get_deflated_eigpairs(nep, lam=None, v=None):
    """Eigenpairs of the original NEP from the invariant pair: eigenvalues
    (numpy) and eigenvectors (a tensor on the original's device)."""
    if lam is None:
        S, V = nep.S0, nep.V0
    else:
        S, V = _extend_pair(nep, lam,
                            np.asarray(_host(v), dtype=complex).reshape(-1))
    D, X = np.linalg.eig(S)
    return D, torch.as_tensor(V[:nep.n0, :] @ X, device=nep.V0_t.device)
