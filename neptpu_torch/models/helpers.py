"""Function-handle NEPs: user callbacks wrapped as problems.

* ``Mder_NEP(n, Mder_fn; maxder=inf)`` - Mder from a callback; Mlincomb
  falls back to the sum of derivative-matrix actions.
* ``Mder_Mlincomb_NEP(n, Mder_fn, Mlincomb_fn; maxder...)`` - both
  callbacks.
* ``REP(A, roots, poles)`` - a rational eigenproblem in root/pole form,
  lowered to an SPMF.

A callback's results are taken as tensors where it returns them (on its
own device); numpy results become CPU tensors."""
from __future__ import annotations

import numpy as np
import torch

from ..core.nep import NEP, mlincomb_from_mder
from ..ops import matfun
from .spmf import SPMF_NEP

__all__ = ["Mder_NEP", "Mder_Mlincomb_NEP", "REP"]


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class Mder_NEP(NEP):
    def __init__(self, n, Mder_fn, maxder=np.inf):
        self.n = n
        self._mder = Mder_fn
        self.maxder = maxder

    def Mder(self, lam, der: int = 0):
        if der > self.maxder:
            raise ValueError(f"derivative {der} exceeds maxder={self.maxder}")
        return _tensor(self._mder(lam, der))

    Mder_dense = Mder

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        return mlincomb_from_mder(self, lam, V, a, startder)


class Mder_Mlincomb_NEP(Mder_NEP):
    def __init__(self, n, Mder_fn, Mlincomb_fn, maxder=np.inf,
                 maxder_lincomb=np.inf):
        super().__init__(n, Mder_fn, maxder)
        self._mlincomb = Mlincomb_fn
        self.maxder_lincomb = maxder_lincomb

    def Mlincomb(self, lam, V, a=None, startder: int = 0):
        if V.ndim == 1:
            V = V[:, None]
        k = V.shape[1]
        if k - 1 + startder > self.maxder_lincomb:
            return mlincomb_from_mder(self, lam, V, a, startder)
        a = torch.ones(k, dtype=torch.float64) if a is None else _tensor(a)
        return _tensor(self._mlincomb(lam, V, a, startder))


def _root_eval(S, roots):
    """``prod_i (S - r_i I)`` as a matrix polynomial."""
    I = matfun.eye_like(S)
    F = None
    for r in roots:
        term = S - r * I
        F = term if F is None else F @ term
    return I if F is None else F


def REP(A, roots, poles, device=None):
    """``-lam I + A0 + A1 p(lam)/q(lam)`` with monic p, q from their roots
    and poles; ``device``: where its bank lives (default: the card)."""
    A0, A1 = A
    n = np.asarray(A0).shape[0]
    roots = [complex(r) for r in np.asarray(roots, dtype=complex)]
    poles = [complex(p) for p in np.asarray(poles, dtype=complex)]

    def ratfun(S):
        q = _root_eval(S, poles)
        p = _root_eval(S, roots)
        return torch.linalg.solve(q, p) if S.ndim else p / q

    return SPMF_NEP([np.eye(n), np.asarray(A0), np.asarray(A1)],
                    [lambda S: -S, matfun.eye_like, ratfun], device=device)
