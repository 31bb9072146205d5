"""``shift_and_scale`` / ``mobius_transform`` / ``taylor_expansion_pep``.

The specialisations keep the problem's type and storage: a PEP's
coefficients are recombined (sparse stays sparse), a DEP's terms are scaled
and its shift joins as one more delay-free term (a banded problem stays a
DIA bank), an SPMF's term functions are composed over the same bank.  Other
problems get a generic wrapper.  The new problem lives on the original's
device."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.nep import (NEP, compute_Mder, compute_Mlincomb, compute_MM,
                        mder_from_mm, mlincomb_from_mm)
from ..models.dep import DEP
from ..models.pep import PEP
from ..models.spmf import SPMF_NEP
from ..ops import matfun
from ..ops.sparse import make_term_bank
from ..solvers.common import nep_device

__all__ = [
    "shift_and_scale",
    "mobius_transform",
    "taylor_expansion_pep",
    "ShiftScaledNEP",
    "MobiusTransformedNEP",
]


def _dense(M):
    return M if isinstance(M, torch.Tensor) else M.to_dense()


def _host_terms(bank):
    """A bank's terms on the host: scipy CSR for a sparse bank, numpy
    arrays for a dense one."""
    mats = bank.host_csr_terms()
    return mats if bank.is_sparse else [A.toarray() for A in mats]


def _bank_like(orgbank, mats, device):
    """A term bank over ``mats`` in ``orgbank``'s storage (DIA, CSR or
    dense), whatever size picks by default."""
    from ..ops.dia import DiaTermBank
    from ..ops.sparse import SparseTermBank

    fmt = ("dia" if isinstance(orgbank, DiaTermBank) else
           "csr" if isinstance(orgbank, SparseTermBank) else "dense")
    return make_term_bank(mats, fmt=fmt, device=device)


class ShiftScaledNEP(NEP):
    """``T(lam) = M(scale * lam + shift)`` for a generic NEP."""

    def __init__(self, orgnep: NEP, shift=0.0, scale=1.0):
        self.orgnep = orgnep
        self.shift = shift
        self.scale = scale
        self.n = orgnep.n

    def Mder(self, lam, der: int = 0):
        M = compute_Mder(self.orgnep, self.scale * lam + self.shift, der)
        return (self.scale ** der) * _dense(M)

    def Mder_dense(self, lam, der: int = 0):
        return self.Mder(lam, der)

    def MM(self, S, V):
        eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
        return compute_MM(self.orgnep, S * self.scale + self.shift * eye, V)

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if V.ndim == 1:
            V = V[:, None]
        p = V.shape[1]
        z = torch.as_tensor(np.asarray(self.scale, dtype=complex)
                            ** np.arange(startder, startder + p))
        W = V * z.to(V.device)[None, :]
        return compute_Mlincomb(self.orgnep, self.scale * lam + self.shift,
                                W, a, startder)


def shift_and_scale(orgnep: NEP, shift=0.0, scale=1.0):
    """``T(lam) = M(scale * lam + shift)``, of the original's type where it
    is a PEP, a DEP or an SPMF."""
    device = nep_device(orgnep)
    if isinstance(orgnep, PEP):
        # T(lam) = sum_j (sum_{i >= j} binom(i, j) scale^j shift^(i-j) A_i)
        Av = _host_terms(orgnep.bank)
        m = len(Av) - 1
        At = []
        for j in range(m + 1):
            AA = None
            for i in range(j, m + 1):
                factor = (scale ** j) * (shift ** (i - j)) * math.factorial(
                    i) / (math.factorial(i - j) * math.factorial(j))
                AA = Av[i] * factor if AA is None else AA + Av[i] * factor
            At.append(AA)
        return PEP(None, bank=_bank_like(orgnep.bank, At, device))
    if isinstance(orgnep, DEP):
        # T(lam) = M(scale lam + shift) / scale: each term scaled by
        # exp(-tau shift) / scale, delays by scale, and -shift/scale I as a
        # delay-free term (the -lam I of a DEP stays implicit)
        import scipy.sparse as sp

        tau = np.asarray(orgnep.tauv)
        scales = np.exp(-tau * shift) / scale
        A = [Ai * si for Ai, si in zip(_host_terms(orgnep.bank), scales)]
        eye = (sp.eye(orgnep.n, format="csr") if orgnep.bank.is_sparse
               else np.eye(orgnep.n))
        return DEP(None, tauv=list(tau * scale) + [0.0], bank=_bank_like(
            orgnep.bank, A + [eye * (-shift / scale)], device))
    if isinstance(orgnep, SPMF_NEP):
        fv = [(lambda S, f=f: f(scale * S + shift * matfun.eye_like(S)))
              for f in orgnep.get_fv()]
        return SPMF_NEP([None] * len(fv), fv, bank=orgnep.bank)
    return ShiftScaledNEP(orgnep, shift=shift, scale=scale)


class MobiusTransformedNEP(NEP):
    """``T(lam) = M((a lam + b) / (c lam + d))`` for a generic NEP."""

    def __init__(self, orgnep: NEP, a=1.0, b=0.0, c=0.0, d=1.0):
        self.orgnep = orgnep
        self.a, self.b, self.c, self.d = a, b, c, d
        self.n = orgnep.n

    def MM(self, S, V):
        eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
        num = self.a * S + self.b * eye
        den = self.c * S + self.d * eye
        return compute_MM(self.orgnep, torch.linalg.solve(den, num), V)

    def Mder(self, lam, der: int = 0):
        return mder_from_mm(self, lam, der)

    def Mder_dense(self, lam, der: int = 0):
        return self.Mder(lam, der)

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return mlincomb_from_mm(self, lam, V, a, startder)


def mobius_transform(orgnep: NEP, a=1.0, b=0.0, c=0.0, d=1.0):
    """``T(lam) = M((a lam + b) / (c lam + d))``; an SPMF keeps its bank and
    gets composed term functions."""
    if isinstance(orgnep, SPMF_NEP):
        def make(f):
            def g(S):
                eye = matfun.eye_like(S)
                num = a * S + b * eye
                den = c * S + d * eye
                return f(torch.linalg.solve(den, num) if S.ndim >= 2
                         else num / den)

            return g

        return SPMF_NEP([None] * len(orgnep.get_fv()),
                        [make(f) for f in orgnep.get_fv()], bank=orgnep.bank)
    return MobiusTransformedNEP(orgnep, a=a, b=b, c=c, d=d)


def taylor_expansion_pep(nep: NEP, d: int = 2):
    """The Taylor series of ``M`` at 0 truncated at degree ``d``, as a PEP
    (dense coefficients ``M^(i)(0) / i!``, on the original's device)."""
    A = [_dense(compute_Mder(nep, 0.0, i)).detach().cpu().numpy()
         / math.factorial(i) for i in range(d + 1)]
    return PEP(A, device=nep_device(nep))
